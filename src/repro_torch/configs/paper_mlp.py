"""The paper's own models (Sec. V-A), port of `repro/configs/paper_mlp.py`:

  MNIST MLP        : 784 -> 128 -> 10
  Hand Gesture MLP : 4096 -> 128 -> 20

plus the Algorithm 1 ensemble settings (33 thresholds, {0, 2, ..., 64})
and `deploy_mlp`, the persistable `deploy.Deployment` of a paper MLP.
"""

from repro_torch.core.bnn import MLPConfig
from repro_torch.core.ensemble import EnsembleConfig, PAPER_THRESHOLDS

MNIST_MLP = MLPConfig(layer_sizes=(784, 128, 10), bias_cells=64)
HG_MLP = MLPConfig(layer_sizes=(4096, 128, 20), bias_cells=64)

PAPER_ENSEMBLE = EnsembleConfig(
    thresholds=PAPER_THRESHOLDS, bias_cells=64, mode="fused"
)


def deploy_mlp(cfg: MLPConfig, model, *, noise=None, **kw):
    """`deploy.deploy` with the config's bias cells: `model` is
    `bnn.fold` output or trained parameters (folded here); `kw` takes
    `device=` and the compile options."""
    from repro_torch.deploy import deploy

    return deploy(model, config=cfg, noise=noise, **kw)

# Baseline software accuracies reported by the paper (Sec. V-A)
PAPER_MNIST_TOP1 = 0.952
PAPER_HG_TOP1 = 0.935
PAPER_HG_SOFTWARE_TOP1 = 0.99
