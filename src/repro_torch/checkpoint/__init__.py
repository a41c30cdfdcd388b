"""Checkpoint directories shared with the JAX package (`ckpt`)."""
