"""Input packing: the float32 rows `CompiledPipeline.run` packs, in one
launch.

    sign_words(x)             ±1 rows [B, n] -> [B, ceil(n/32)] words,
                              bit i of word j = x[32j+i] > 0
    threshold_words(x, enc)   pixels [B, P] -> [B, P, Cw] words, bit t
                              of word w = x >= level 32w+t of enc

The words are the port's int32 view of little-endian uint32 words, bit 31
included, the tail word's padding bits 0.  `CompiledPipeline._pack_input`
calls `sign_words` for an MLP with hidden layers and, through
`ConvFront.pack`, `threshold_words` for a CNN whose encoding is a
thermometer or the sign code (a bit-plane code and a head-only MLP keep
their plain routes).  The kernel makes the levels itself, the same
float32 values as `binarize.thermometer_thresholds` (or 0.5), so a call
copies nothing to the card; `launched` counts both entries' launches.

Tensors on the card launch `csrc/pack_input.cu` (counted in each
function's `launches`); tensors on the CPU take the plain versions, which
are the kernel's twins: `binarize.pack_pm1` and `InputEncoding.pack`.
The kernel's words equal theirs bit for bit.  Nothing falls back: a
failed launch raises.  The reference packs its inputs in XLA and has no
Pallas kernel for it; its words equal these except on denormal inputs,
which XLA reads as zero (a positive denormal packs 0 there, 1 here, as
IEEE's x > 0 says; tests/test_torch_pack_input.py pins that).
"""

from __future__ import annotations

import torch

from repro_torch.core import binarize
from repro_torch.kernels import _build


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be [B, n], got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def launched() -> int:
    """The launches of both entries so far (`run.pack` counts the change
    across a call's packing)."""
    return sign_words.launches + threshold_words.launches


def sign_words(x: torch.Tensor) -> torch.Tensor:
    """±1 rows [B, n] float32 -> packed words [B, ceil(n/32)] int32.

    CUDA tensors launch the kernel; CPU tensors take `binarize.pack_pm1`.
    """
    _check(x)
    if not x.is_cuda:
        return binarize.pack_pm1(x)
    b, n = x.shape
    out = torch.empty((b, binarize.packed_width(n)), dtype=torch.int32,
                      device=x.device)
    if out.numel():
        _launch("sign_pack_launch", x, (b, n), out)
        sign_words.launches += 1
    return out


sign_words.launches = 0


def threshold_words(x: torch.Tensor,
                    encoding: binarize.InputEncoding) -> torch.Tensor:
    """Pixels [B, P] float32 -> packed words [B, P, Cw] int32, Cw =
    ceil(width/32), for a thermometer or sign `encoding`.

    CUDA tensors launch the kernel; CPU tensors take `encoding.pack`.
    """
    if encoding.kind == "bitplane":
        raise ValueError("a bit-plane code compares no levels: "
                         "InputEncoding.pack packs it")
    _check(x)
    if not x.is_cuda:
        return encoding.pack(x)
    b, p = x.shape
    out = torch.empty((b, p, binarize.packed_width(encoding.width)),
                      dtype=torch.int32, device=x.device)
    if out.numel():
        _launch("threshold_pack_launch", x,
                (b * p, int(encoding.kind == "sign"), encoding.width), out)
        threshold_words.launches += 1
    return out


threshold_words.launches = 0


def _launch(fn: str, x: torch.Tensor, args: tuple, out: torch.Tensor):
    xc = x.contiguous()
    lib = _build.library("pack_input")
    with torch.cuda.device(xc.device):
        stream = torch.cuda.current_stream(xc.device).cuda_stream
        err = getattr(lib, fn)(xc.data_ptr(), *args, out.data_ptr(), stream)
    _build.check(lib, err, fn)
