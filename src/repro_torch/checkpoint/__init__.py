"""Checkpointing: msgpack pytree snapshots, atomic, keep-k (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (all_steps, latest_step,
                                          restore_checkpoint, save_checkpoint)

__all__ = ["all_steps", "latest_step", "restore_checkpoint",
           "save_checkpoint"]
