"""The plain reference of the paper's classifiers: float ±1 arithmetic in
plain PyTorch, with no packing, no kernels and no batching tricks.

A hidden layer is sign(W x + C) (Eq. 3, sign(0) = +1); a conv layer the
same over a VALID ±1 convolution; the flatten is NHWC.  The head is the
CAM of Eq. 4: each class row is its ±1 weights followed by `bias_cells`
cells, p = (C' + bias_cells) / 2 of them at +1 (C' is C clipped to the
cells and, when its parity differs from theirs, rounded down by one); the
query is the hidden signs followed by `bias_cells` +1 drive bits.  A row
votes once for every pass t whose threshold holds its Hamming distance,
HD <= T_t, with the paper's sweep centred on the row's majority point,
T_t = n_total // 2 - max(sweep) // 2 + sweep_t.  Under silicon noise the
thresholds are each row's own float32 draws (`keyed.thresholds`).

Everything is exact: ±1 products summed in float32 are integers far
below 2**24, and TF32 is off.  `control` switches in one departure, for
the check that the comparison can fail:

  "bf16_inputs"     : the rows rounded to bfloat16 before encoding;
  "half_bias_cells" : the head built with half the configuration's bias
                      cells, so |C| above them is clipped;
  "float32_normals" : the silicon draws' Box-Muller in float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from bench.reference import calibration, keyed

CONTROLS = ("bf16_inputs", "half_bias_cells", "float32_normals")


@contextlib.contextmanager
def full_fp32():
    """float32 matmuls and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def thermometer_levels(width: int) -> np.ndarray:
    """(t + 1) / (width + 1) for t < width, IEEE float32."""
    return (np.arange(width, dtype=np.float32) + np.float32(1.0)) \
        / np.float32(width + 1.0)


def _sign(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, 1.0, -1.0)


def hidden_signs(net: dict, cfg: dict, x: torch.Tensor,
                 control=None) -> torch.Tensor:
    """The ±1 query of the head's weight cells [B, n_hidden] float32."""
    x = x.to(torch.float32)
    if control == "bf16_inputs":
        x = x.to(torch.bfloat16).to(torch.float32)
    b = x.shape[0]
    with full_fp32():
        if cfg["model"] == "cnn":
            enc = cfg["encoding"]
            if enc["kind"] != "thermometer":
                raise ValueError("the reference encodes thermometer codes")
            lv = torch.from_numpy(thermometer_levels(enc["width"])).to(
                x.device)
            side = cfg["side"]
            h = _sign((x.reshape(b, side, side, 1) >= lv).to(torch.float32)
                      - 0.5)  # NHWC ±1
            h = h.permute(0, 3, 1, 2)
            for layer in net["conv"]:
                w = layer["w"].to(x.device, torch.float32).permute(0, 3, 1, 2)
                c = layer["c"].to(x.device, torch.float32)
                h = _sign(torch.nn.functional.conv2d(
                    h, w, stride=layer["stride"]) + c[None, :, None, None])
            h = h.permute(0, 2, 3, 1).reshape(b, -1)
        else:
            h = x
        for layer in net["fc"][:-1]:
            w = layer["w"].to(x.device, torch.float32)
            c = layer["c"].to(x.device, torch.float32)
            h = _sign(h @ w.T + c)
    return h


def head_rows(layer: dict, bias_cells: int) -> torch.Tensor:
    """The head's CAM rows [C, n_hidden + bias_cells] as ±1 float32."""
    c = layer["c"].to(torch.int64).clamp(-bias_cells, bias_cells)
    c = torch.where((c + bias_cells) % 2 != 0, c - 1, c)
    p = (c + bias_cells) // 2
    cells = torch.arange(bias_cells, device=c.device)[None, :] < p[:, None]
    return torch.cat([layer["w"].to(torch.float32),
                      _sign(cells.to(torch.float32) - 0.5)], dim=1)


def head_distances(h: torch.Tensor, layer: dict, bias_cells: int
                   ) -> torch.Tensor:
    """Hamming distances [B, C] float32 of the queries to the rows."""
    rows = head_rows({k: v.to(h.device) for k, v in layer.items()},
                     bias_cells)
    q = torch.cat([h, torch.ones((h.shape[0], bias_cells),
                                 device=h.device)], dim=1)
    with full_fp32():
        return (rows.shape[1] - q @ rows.T) / 2


def sweep(cfg: dict, bias_cells: int, n_hidden: int) -> torch.Tensor:
    """The head's integer thresholds [P] float32."""
    s = np.asarray(cfg["thresholds"], np.int64)
    t = (n_hidden + bias_cells) // 2 - s.max() // 2 + s
    return torch.from_numpy(t.astype(np.float32))


def bias_cells(cfg: dict, control=None) -> int:
    """The head's bias cells (halved by the "half_bias_cells" control)."""
    return cfg["bias_cells"] // (2 if control == "half_bias_cells" else 1)


def distances(net: dict, cfg: dict, x: torch.Tensor, control=None,
              block: int = 4096) -> torch.Tensor:
    """Head Hamming distances [B, C] float32 of rows `x` (±1 for an MLP,
    [0, 1] pixels for a CNN), in blocks of `block` rows."""
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    bias = bias_cells(cfg, control)
    return torch.cat([
        head_distances(hidden_signs(net, cfg, x[i:i + block], control),
                       net["fc"][-1], bias)
        for i in range(0, x.shape[0], block)])


def votes_from(hd: torch.Tensor, net: dict, cfg: dict, key_words=None,
               noise=None, control=None) -> torch.Tensor:
    """int32 votes [B, C] of head distances `hd`; with `noise` (a dict of
    the silicon model's sigmas), each row's thresholds come from its key
    words [B, 2]."""
    base_host = sweep(cfg, bias_cells(cfg, control),
                      net["fc"][-1]["w"].shape[1])
    base = base_host.to(hd.device)
    if noise is None:
        t = base[:, None, None]
    else:
        m_log, dmdv = calibration.pass_fields(
            base_host.numpy(), noise["sigma_vref"], noise["sigma_tjitter"])
        words = key_words.to(hd.device, torch.int64) & 0xFFFFFFFF
        dev = hd.device
        t = keyed.thresholds(words, base, torch.from_numpy(m_log).to(dev),
                             torch.from_numpy(dmdv).to(dev), noise,
                             hd.shape[1],
                             float64=control != "float32_normals")[:, 0]
    return (hd[None] <= t).sum(0, dtype=torch.int32)


def votes(net: dict, cfg: dict, x: torch.Tensor, key_words=None,
          noise=None, control=None) -> torch.Tensor:
    """int32 votes [B, C] of rows `x` (`distances`, then `votes_from`)."""
    return votes_from(distances(net, cfg, x, control), net, cfg, key_words,
                      noise, control)
