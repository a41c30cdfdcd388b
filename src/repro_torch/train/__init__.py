"""Training substrate (port of `repro.train`): AdamW with float32
masters, the microbatched train step, 1-bit gradient compression
(EF-signSGD)."""

from repro_torch.train.optimizer import OptimizerConfig, init_opt_state, apply_updates  # noqa: F401
from repro_torch.train.train_step import TrainConfig, init_train_state, make_train_step, train_step  # noqa: F401
from repro_torch.train.grad_compress import CompressionConfig  # noqa: F401
