"""The paper's own models (Sec. V-A), port of `repro/configs/paper_mlp.py`:

  MNIST MLP        : 784 -> 128 -> 10
  Hand Gesture MLP : 4096 -> 128 -> 20

plus the Algorithm 1 ensemble settings (33 thresholds, {0, 2, ..., 64}).
`deploy_mlp` waits for the deployment slice.
"""

from repro_torch.core.bnn import MLPConfig
from repro_torch.core.ensemble import EnsembleConfig, PAPER_THRESHOLDS

MNIST_MLP = MLPConfig(layer_sizes=(784, 128, 10), bias_cells=64)
HG_MLP = MLPConfig(layer_sizes=(4096, 128, 20), bias_cells=64)

PAPER_ENSEMBLE = EnsembleConfig(
    thresholds=PAPER_THRESHOLDS, bias_cells=64, mode="fused"
)

# Baseline software accuracies reported by the paper (Sec. V-A)
PAPER_MNIST_TOP1 = 0.952
PAPER_HG_TOP1 = 0.935
PAPER_HG_SOFTWARE_TOP1 = 0.99
