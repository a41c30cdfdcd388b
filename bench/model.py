"""What the benchmark makes from `--seed`: the weights of a configuration,
the pool of input rows, and the rows' key words; and the system under
test built from them through its normal entry point.

Weights are random deployed layers (±1 rows, integer C with the fold's
parity rule, so sign(W x + C) never meets 0), drawn on the device by one
`torch.Generator`, in a few large calls.  No kernel's work depends on
the values, so random rows stand in for images; they also keep set-up
short.  The same seed gives the same weights, rows and keys on one kind
of device.
"""

from __future__ import annotations

import numpy as np
import torch


def parity_adjust(c: np.ndarray, n_in: int, bias_cells: int) -> np.ndarray:
    """Clip C to the bias cells with the opposite parity of the dot width
    n_in, so that y + C is never 0 (the fold's rule)."""
    c = np.asarray(c, np.int64)
    c = np.where((c + n_in) % 2 == 0, c + 1, c)
    c = np.clip(c, -bias_cells, bias_cells)
    return np.where((c + n_in) % 2 == 0, c - np.sign(c).astype(c.dtype), c)


def make_net(cfg: dict, gen: torch.Generator) -> dict:
    """{"conv": [{"w" [c_out, k, k, c_in] int8 ±1, "c" int64, "stride"}],
    "fc": [{"w" [n_out, n_in] int8 ±1, "c" int64}]}, on the CPU, drawn
    from `gen` on its device."""
    dev, bias, cmax = gen.device, cfg["bias_cells"], cfg["c_max"]

    def pm1(shape):
        bits = torch.randint(0, 2, shape, generator=gen, device=dev,
                             dtype=torch.int8)
        return (bits * 2 - 1).cpu()

    def consts(n_out, n_in):
        c = torch.randint(-cmax, cmax + 1, (n_out,), generator=gen,
                          device=dev).cpu().numpy()
        return torch.from_numpy(parity_adjust(c, n_in, bias))

    net = {"conv": [], "fc": []}
    if cfg["model"] == "cnn":
        side, c_in = cfg["side"], cfg["encoding"]["width"]
        for layer in cfg["conv"]:
            k, c_out = layer["k"], layer["c_out"]
            net["conv"].append(dict(w=pm1((c_out, k, k, c_in)),
                                    c=consts(c_out, k * k * c_in),
                                    stride=layer["stride"]))
            side = (side - k) // layer["stride"] + 1
            c_in = c_out
        sizes = [side * side * c_in, *cfg["hidden"], cfg["n_classes"]]
    else:
        sizes = list(cfg["layer_sizes"])
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        net["fc"].append(dict(w=pm1((n_out, n_in)), c=consts(n_out, n_in)))
    return net


def make_rows(cfg: dict, gen: torch.Generator, pool: int,
              batch: int) -> torch.Tensor:
    """The input pool [pool, batch, n_in] float32 on the generator's
    device: ±1 rows for an MLP (what `run` takes), raw [0, 1) pixels for a
    CNN."""
    n_in = (cfg["side"] ** 2 if cfg["model"] == "cnn"
            else cfg["layer_sizes"][0])
    shape = (pool, batch, n_in)
    if cfg["model"] == "cnn":
        return torch.rand(shape, generator=gen, device=gen.device)
    x = torch.empty(shape, device=gen.device)
    return x.bernoulli_(0.5, generator=gen).mul_(2).sub_(1)


def make_keys(gen: torch.Generator, pool: int, batch: int) -> torch.Tensor:
    """Raw uint32 key words [pool, batch, 2], held as int64: every row of
    the pool its own key."""
    return torch.randint(0, 1 << 32, (pool, batch, 2), generator=gen,
                         device=gen.device, dtype=torch.int64)


def build_pipeline(cfg: dict, net: dict, noise: dict | None, device):
    """The system under test: `compile_pipeline` over the folded layers,
    with the silicon noise model when the traffic asks for one."""
    from repro_torch.core.binarize import InputEncoding
    from repro_torch.core.bnn import FoldedLayer
    from repro_torch.core.convnet import FoldedConvLayer
    from repro_torch.core.device_model import NoiseModel
    from repro_torch.core.ensemble import EnsembleConfig
    from repro_torch.pipeline import compile_pipeline

    folded = [FoldedConvLayer(weights_pm1=l["w"].numpy(), c=l["c"].numpy(),
                              stride=l["stride"]) for l in net["conv"]]
    folded += [FoldedLayer(weights_pm1=l["w"].numpy(), c=l["c"].numpy())
               for l in net["fc"]]
    ens = EnsembleConfig(thresholds=tuple(cfg["thresholds"]),
                         bias_cells=cfg["bias_cells"])
    kw = {}
    if cfg["model"] == "cnn":
        enc = cfg["encoding"]
        kw = dict(image_side=cfg["side"],
                  image_encoding=InputEncoding(enc["kind"], enc["width"]))
    return compile_pipeline(folded, ens, device=device,
                            noise=None if noise is None else NoiseModel(**noise),
                            **kw)
