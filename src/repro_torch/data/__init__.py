"""Data pipelines (port of `repro.data`): synthetic image datasets (paper
eval), token streams (LM substrate), frontend-stub embedding streams
(vlm/audio archs)."""

from repro_torch.data.synthetic import (  # noqa: F401
    HG_LIKE,
    MNIST_LIKE,
    DatasetSpec,
    binarize_images,
    make_dataset,
)
from repro_torch.data.tokens import (  # noqa: F401
    DataConfig,
    memmap_stream,
    synthetic_stream,
)
