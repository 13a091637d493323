from repro_torch.data.tokens import TokenPipeline

__all__ = ["TokenPipeline"]
