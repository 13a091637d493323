"""Atomic and asynchronous checkpoints of the port's training state, in
the reference's on-disk format."""

from repro_torch.checkpoint.store import (AsyncSaver, latest_step,
                                          list_steps, prune, read_manifest,
                                          restore, save)

__all__ = ["AsyncSaver", "latest_step", "list_steps", "prune",
           "read_manifest", "restore", "save"]
