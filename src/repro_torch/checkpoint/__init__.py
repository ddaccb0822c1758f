"""Checkpointing: msgpack pytree snapshots, atomic, keep-k, elastic
restore onto a mesh (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.store import (all_steps, latest_step,
                                          restore_checkpoint,
                                          restore_to_shardings,
                                          save_checkpoint)

__all__ = ["all_steps", "latest_step", "restore_checkpoint",
           "restore_to_shardings", "save_checkpoint"]
