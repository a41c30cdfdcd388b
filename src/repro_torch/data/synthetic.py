"""Synthetic drop-in datasets for the paper's evaluation (the port's own
copy of `repro/data/synthetic.py`, which is numpy only: the same seed
gives the same arrays, bit for bit).

The paper evaluates on MNIST (10 classes, 28x28) and the Kaggle Hand
Gesture dataset (20 classes, 64x64).  Neither ships with the repository,
so these are *procedural* datasets with identical shapes and class
counts: per-class stroke-glyph templates rendered with random shift /
shear / pixel noise.

Deterministic by seed; images in [0,1]; `binarize_images` maps to the
±1 domain the CAM consumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_classes: int
    side: int  # image side (square)

    @property
    def n_pixels(self) -> int:
        """Flattened image length (side^2)."""
        return self.side * self.side


MNIST_LIKE = DatasetSpec("mnist-like", 10, 28)
HG_LIKE = DatasetSpec("hg-like", 20, 64)


def _glyph_template(rng: np.random.Generator, side: int) -> np.ndarray:
    """A class template: a few random thick strokes on a side x side grid."""
    if side < 8:
        raise ValueError(f"glyph side must be >= 8, got {side}")
    img = np.zeros((side, side), np.float32)
    n_strokes = rng.integers(2, 5)
    for _ in range(n_strokes):
        x0, y0 = rng.integers(2, side - 2, 2)
        angle = rng.uniform(0, 2 * np.pi)
        length = rng.integers(side // 3, side - 4)
        thick = max(1, side // 14)
        for t in range(length):
            x = int(x0 + t * np.cos(angle))
            y = int(y0 + t * np.sin(angle))
            if 0 <= x < side and 0 <= y < side:
                # numpy clips the upper bound; the lower is clamped so a
                # near-edge stroke thickens inward instead of wrapping
                img[
                    max(x - thick, 0) : x + thick, max(y - thick, 0) : y + thick
                ] = 1.0
    return img


def _shift_fill(a: np.ndarray, shift: int, axis: int) -> np.ndarray:
    """np.roll with zero fill: pixels shifted past the edge DROP.

    np.roll wraps content to the opposite edge — at 28x28 the glyphs sit
    far enough from the border that this never showed, but the 64x64 HG
    shape draws strokes up to `side - 4` long, and shear offsets grow
    with the row index, so reusing the generator at CNN input widths
    silently teleported stroke pixels across the image (label noise with
    no visual justification).  Augmentation must lose, not wrap, what
    leaves the frame.
    """
    if shift == 0:
        return a
    out = np.zeros_like(a)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    if shift > 0:
        dst[axis], src[axis] = slice(shift, None), slice(None, -shift)
    else:
        dst[axis], src[axis] = slice(None, shift), slice(-shift, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def _augment(
    rng: np.random.Generator, template: np.ndarray, noise: float
) -> np.ndarray:
    side = template.shape[0]
    dx, dy = rng.integers(-2, 3, 2)
    img = _shift_fill(_shift_fill(template, int(dx), 0), int(dy), 1)
    # shear-ish distortion: per-row shift (zero-filled, no wrap-around)
    shear = rng.integers(-1, 2)
    if shear:
        img = img.copy()
        for r in range(side):
            img[r] = _shift_fill(img[r], (r * shear) // max(side // 4, 1), 0)
    img = img + rng.normal(0, noise, img.shape).astype(np.float32)
    flip = rng.random(img.shape) < noise * 0.15
    img = np.where(flip, 1.0 - img, img)
    return np.clip(img, 0.0, 1.0)


def make_dataset(
    spec: DatasetSpec,
    n_train: int = 8000,
    n_test: int = 2000,
    noise: float = 0.15,
    seed: int = 0,
):
    """Returns (train_x, train_y, test_x, test_y); x in [0,1] [N, side^2]."""
    rng = np.random.default_rng(seed)
    templates = [
        _glyph_template(rng, spec.side) for _ in range(spec.n_classes)
    ]
    def gen(n):
        xs = np.empty((n, spec.n_pixels), np.float32)
        ys = np.empty((n,), np.int64)
        for i in range(n):
            c = int(rng.integers(spec.n_classes))
            xs[i] = _augment(rng, templates[c], noise).reshape(-1)
            ys[i] = c
        return xs, ys

    train_x, train_y = gen(n_train)
    test_x, test_y = gen(n_test)
    return train_x, train_y, test_x, test_y


def binarize_images(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """[0,1] pixels -> +-1 (the end-to-end-binary input coding)."""
    return np.where(x >= threshold, 1.0, -1.0).astype(np.float32)
