"""Synthetic image datasets for training and evaluation (port of
`repro.data`, its image half)."""

from repro_torch.data.synthetic import (  # noqa: F401
    HG_LIKE,
    MNIST_LIKE,
    DatasetSpec,
    binarize_images,
    make_dataset,
)
