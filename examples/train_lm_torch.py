"""Train an LM of any family end to end on a 2x1 process mesh (reduced
config).

The twin of ``examples/train_lm.py``: the same reduced config (default
qwen2-0.5b), the reference's seed-0 weights, AdamW on
``warmup_cosine(3e-3, 5, steps)``, ``TokenPipeline`` batches of 8 x 64
tokens, 2 microbatches, on a (data 2, model 1) mesh: two ranks, each
holding its shard of every parameter and AdamW moment and training on
its rows of the batch (``train.steps``), a loss line every 5 steps.  As
the reference example, it does not checkpoint.  The ranks are processes
(``launch.mesh.run_on_mesh``): gloo on the CPU, NCCL on two cards; with
one card it stops and says so.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [arch] [steps] \\
          [--device cpu]
e.g.  PYTHONPATH=src python examples/train_lm_torch.py mixtral-8x7b 30 \\
          --device cpu
"""

import argparse

import torch
import torch.distributed as dist

from repro_torch.data import TokenPipeline
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import rank_device, run_on_mesh
from repro_torch.models.params import count_params, init_params
from repro_torch.models.registry import get_config
from repro_torch.models.transformer import LM, build_defs
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train.steps import build_train_step, init_train_state

MESH = (2, 1)
MICROBATCHES = 2


def train(mesh, arch: str, steps: int, device: str) -> None:
    """One rank's loop; rank 0 prints."""
    log = print if dist.get_rank() == 0 else (lambda *a: None)
    dev = rank_device(device)
    cfg = get_config(arch).reduced()
    defs = build_defs(cfg)
    model = LM(cfg, init_params(defs, seed=0, device=dev), trainable=True)
    rules = ShardingRules.default()
    log(f"{cfg.name}: {count_params(defs)/1e6:.2f}M params, "
        f"family={cfg.family}, {MESH[0]}x{MESH[1]} mesh "
        f"({dist.get_backend()})")
    opt = adamw(warmup_cosine(3e-3, 5, steps))
    step_fn = build_train_step(model, opt, mesh, rules,
                               microbatches=MICROBATCHES)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=64,
                         global_batch=8)
    state = init_train_state(model, opt, mesh, rules)
    rows = dict(rank=mesh.get_local_rank("data"), ranks=MESH[0],
                microbatches=MICROBATCHES)
    for i in range(steps):
        state, m = step_fn(state, pipe.torch_batch(i, dev, **rows))
        if (i + 1) % 5 == 0:
            log(f"step {i+1:3d}  loss={float(m['loss']):.4f}  "
                f"lr={float(m['lr']):.2e}")
    log("done")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="?", default="qwen2-0.5b")
    ap.add_argument("steps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < MESH[0]:
        raise SystemExit(
            f"this example trains on {MESH[0]} ranks, one card each, and "
            f"this machine has {torch.cuda.device_count()} card(s): pass "
            "--device cpu to run its ranks on the CPU")
    run_on_mesh(MESH, ("data", "model"), args.device, train, args.arch,
                args.steps, args.device)
