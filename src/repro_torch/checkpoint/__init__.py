"""Atomic / async / elastic checkpointing (`ckpt`, directories shared with
the JAX package)."""

from repro_torch.checkpoint.ckpt import (  # noqa: F401
    AsyncCheckpointer,
    latest_step,
    restore,
    save,
)
