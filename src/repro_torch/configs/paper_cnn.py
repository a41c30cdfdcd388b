"""End-to-end-binary CNN configs for the paper's two image tasks (port of
`repro/configs/paper_cnn.py`):

  MNIST CNN (28x28, 10 classes):
      thermometer-8 input -> 3x3x32 s2 conv -> 3x3x32 s2 conv
      -> flatten 1152 -> FC 128 -> CAM head (10 rows, 33-pass vote)
  HG CNN (64x64, 20 classes):
      thermometer-4 input -> 3x3x32 s2 conv -> 3x3x32 s2 conv
      -> flatten 7200 -> FC 128 -> CAM head (20 rows, 33-pass vote)

Conv channel counts are multiples of 32, so the conv->FC flatten is
word-aligned.  `deploy_cnn` builds the persistable `deploy.Deployment`;
`build_cnn_pipeline` compiles a folded CNN in one call.
"""

from __future__ import annotations

from repro_torch.core.binarize import InputEncoding
from repro_torch.core.convnet import CNNConfig, ConvSpec
from repro_torch.core.ensemble import EnsembleConfig, PAPER_THRESHOLDS
from repro_torch.pipeline import compile_pipeline

MNIST_CNN = CNNConfig(
    side=28,
    encoding=InputEncoding("thermometer", 8),
    conv=(ConvSpec(3, 32, 2), ConvSpec(3, 32, 2)),
    hidden=(128,),
    n_classes=10,
    bias_cells=64,
)

HG_CNN = CNNConfig(
    side=64,
    encoding=InputEncoding("thermometer", 4),
    conv=(ConvSpec(3, 32, 2), ConvSpec(3, 32, 2)),
    hidden=(128,),
    n_classes=20,
    bias_cells=64,
)

CNN_ENSEMBLE = EnsembleConfig(
    thresholds=PAPER_THRESHOLDS, bias_cells=64, mode="fused"
)


def deploy_cnn(cfg: CNNConfig, model, *, noise=None, **kw):
    """The `deploy.Deployment` of an end-to-end CNN: `deploy.deploy` with
    the config's image side, input encoding and bias cells.  `model` is
    `convnet.fold_cnn` / `random_folded_cnn` output or trained
    parameters; `kw` takes `device=` and the compile options."""
    from repro_torch.deploy import deploy

    return deploy(model, config=cfg, noise=noise, **kw)


def build_cnn_pipeline(cfg: CNNConfig, folded, **kw):
    """Compile a folded CNN into the fused end-to-end pipeline.

    What the reference's `deploy_cnn(cfg, folded).pipeline()` compiles:
    the config's image side, input encoding and bias cells, the default
    threshold sweep.  `kw` goes to `compile_pipeline` (device,
    min_bucket, max_bucket, noise, params).
    """
    return compile_pipeline(
        list(folded), EnsembleConfig(bias_cells=cfg.bias_cells),
        image_side=cfg.side, image_encoding=cfg.encoding, **kw,
    )
