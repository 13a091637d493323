"""Per-architecture model configurations (copies of the reference's
``repro/configs``), registered on import by ``models.registry.get_config``."""
