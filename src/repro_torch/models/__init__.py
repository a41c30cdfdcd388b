"""LM substrate (port of `repro.models`): one decoder-only model covering
dense / MoE / SSM / hybrid architectures, plus the paper's binary-LM
integration (`binary_lm`: the BitLinear FFN on kernel 1, the CAM head on
kernels 2 and 1)."""

from repro_torch.models import binary_lm, layers, model, scan, ssm  # noqa: F401
