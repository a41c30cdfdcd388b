"""Layer -> CAM-bank mapping and the silicon throughput/energy model
(port of `repro/core/mapping.py`).

The fabricated macro is 128 kbit in four 32-kbit banks, logically
configurable as 512x256 / 1024x128 / 2048x64 (rows x row-bits).  A search
evaluates every row of the active configuration in ONE clock cycle
(25 MHz), so a binary FC layer of (in <= row_bits, out <= rows) executes in
a single cycle (paper Sec. V-B).

Layers that exceed one configuration are tiled:
  * output tiling (rows): extra row tiles cost extra cycles — exact.
  * input tiling (row bits): the silicon cannot sum matchline charge across
    banks, so a row wider than 256 bits is split into column tiles, and
    the recombination has two readings:
      - ``exact``        — per-tile HDs accumulated digitally, sign at the
                           end (Eq. 3 semantics);
      - ``hierarchical`` — per-tile MAJ decisions recombined by a majority
                           over the tiles (strictly binary, one extra CAM
                           pass in silicon).

`layer_forward` runs on the device of its input; its Hamming distances are
the plain `binarize.hamming_packed`, as the reference's are plain XLA.
`model_inference_cost` is plain Python arithmetic over the tile plans:
the cycle/energy model of the 65 nm macro (25 MHz, 0.8 mW; Table II's
560 K inf/s and 703 M inf/s/W for the MNIST MLP), not of any GPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import binarize
from repro_torch.core.bnn import FoldedLayer
from repro_torch.core.cam import CAMArray, write_weights_with_bias
from repro_torch.core.device_model import BANK_CONFIGS, EnergyModel


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How one folded FC layer maps onto CAM logical configurations."""

    rows: int  # logical rows per tile (config rows)
    row_bits: int  # logical row width (config bits)
    n_row_tiles: int  # output-dim tiles
    n_col_tiles: int  # input-dim tiles
    bias_cells: int  # appended to the LAST column tile
    cycles_per_query: int  # searches to evaluate the full layer once

    @property
    def n_tiles(self) -> int:
        """CAM tiles the layer occupies (row tiles x column tiles)."""
        return self.n_row_tiles * self.n_col_tiles


def plan_layer(
    n_out: int,
    n_in: int,
    bias_cells: int,
    configs: Sequence[tuple[int, int]] = BANK_CONFIGS,
) -> TilePlan:
    """Choose the logical config minimizing cycles for a layer (the first
    of equal ones, in `configs` order)."""
    best: Optional[TilePlan] = None
    for rows, bits in configs:
        n_col = math.ceil((n_in + bias_cells) / bits)
        n_row = math.ceil(n_out / rows)
        plan = TilePlan(
            rows=rows,
            row_bits=bits,
            n_row_tiles=n_row,
            n_col_tiles=n_col,
            bias_cells=bias_cells,
            cycles_per_query=n_col * n_row,
        )
        if best is None or plan.cycles_per_query < best.cycles_per_query:
            best = plan
    if best is None:
        raise ValueError("plan_layer needs at least one bank config")
    return best


@dataclasses.dataclass
class MappedLayer:
    """A folded layer written into (possibly multiple) CAM tiles.

    col_tiles  : CAMArray [n_out, tile bits] per input tile; the last
                 carries the bias cells (a tile of its own when they do
                 not fit beside the last weight bits).
    col_widths : logical (unpadded) bits per tile, bias cells included.
    """

    plan: TilePlan
    col_tiles: list[CAMArray]
    col_widths: list[int]
    n_out: int
    n_in: int
    c: np.ndarray  # [n_out] folded BN constants


def map_layer(layer: FoldedLayer, bias_cells: int = 64) -> MappedLayer:
    """Tile a folded layer onto CAM arrays per its TilePlan."""
    plan = plan_layer(layer.n_out, layer.n_in, bias_cells)
    w = np.asarray(layer.weights_pm1)
    tiles: list[CAMArray] = []
    widths: list[int] = []
    step = plan.row_bits
    # column tiles over the input dimension; bias cells ride on the last
    n_weight_cols = math.ceil(layer.n_in / step)
    for ci in range(n_weight_cols):
        lo, hi = ci * step, min((ci + 1) * step, layer.n_in)
        chunk = w[:, lo:hi]
        if ci == n_weight_cols - 1 and (hi - lo) + bias_cells <= step:
            tiles.append(write_weights_with_bias(chunk, layer.c, bias_cells))
            widths.append(hi - lo + bias_cells)
        else:
            tiles.append(CAMArray.from_pm1(chunk.astype(np.float32)))
            widths.append(hi - lo)
    if widths[-1] == layer.n_in - (n_weight_cols - 1) * step:
        # the bias did not fit on the last weight tile: a tile of its own
        tiles.append(write_weights_with_bias(
            np.zeros((layer.n_out, 0), np.int8), layer.c, bias_cells))
        widths.append(bias_cells)
    return MappedLayer(
        plan=plan,
        col_tiles=tiles,
        col_widths=widths,
        n_out=layer.n_out,
        n_in=layer.n_in,
        c=np.asarray(layer.c),
    )


def _tile_queries(mapped: MappedLayer,
                  x_pm1: torch.Tensor) -> list[torch.Tensor]:
    """Split + pack the query into per-column-tile searchline patterns;
    a tile's bias searchlines are driven to '1'."""
    qs = []
    consumed = 0
    for width in mapped.col_widths:
        n_weight_bits = max(min(width, mapped.n_in - consumed), 0)
        bits = binarize.to_bits(x_pm1[..., consumed:consumed + n_weight_bits])
        consumed += n_weight_bits
        n_bias = width - n_weight_bits
        if n_bias > 0:
            ones = torch.ones((*bits.shape[:-1], n_bias), dtype=torch.uint8,
                              device=bits.device)
            bits = torch.cat([bits, ones], dim=-1)
        qs.append(binarize.pack_bits(bits))
    return qs


def layer_forward(
    mapped: MappedLayer,
    x_pm1: torch.Tensor,
    mode: Literal["exact", "hierarchical"] = "exact",
) -> torch.Tensor:
    """Evaluate sign(Wx + C) through the CAM tiles, on `x_pm1`'s device.

    exact        — digital accumulation of per-tile dots (Eq. 3 oracle).
    hierarchical — strictly binary: per-tile MAJ votes recombined by a
                   majority over tiles (2 * votes >= n_tiles gives +1).
    Returns ±1 float32 activations [..., n_out].
    """
    if mode not in ("exact", "hierarchical"):
        raise ValueError(mode)
    x_pm1 = torch.as_tensor(x_pm1)
    qs = _tile_queries(mapped, x_pm1)
    total = None
    for cam, q, width in zip(mapped.col_tiles, qs, mapped.col_widths):
        hd = cam.to(x_pm1.device).search_hd(q)
        if mode == "exact":
            part = width - 2 * hd  # ±1 dot incl. bias cells on their tile
        else:
            part = (2 * hd <= width).to(torch.int32)  # tile-level MAJ
        total = part if total is None else total + part
    if mode == "exact":
        return torch.where(total >= 0, 1.0, -1.0)
    return torch.where(2 * total >= len(mapped.col_tiles), 1.0, -1.0)


# ---------------------------------------------------------------------------
# Silicon performance model (Table II)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InferenceCost:
    """Modelled cost of one inference on the 65 nm macro."""

    cycles: int
    searches: int
    binary_ops: int  # XNOR+accumulate ops actually performed
    energy_j: float
    latency_s: float

    @property
    def inferences_per_s(self) -> float:
        """Throughput implied by the modeled latency."""
        return 1.0 / self.latency_s if self.latency_s else float("inf")


def model_inference_cost(
    layer_plans: Sequence[TilePlan],
    n_output_passes: int,
    energy: EnergyModel = EnergyModel(),
    batch_per_tune: int = 8192,
    layer_queries: Optional[Sequence[int]] = None,
) -> InferenceCost:
    """Cycle/energy model of one inference (Algorithm 1 flow).

    Hidden layers execute once; the output layer executes
    `n_output_passes` times (the threshold sweep).  Voltage re-tuning
    costs `tuning_cycles`, amortized over `batch_per_tune` images (the
    default reproduces the paper's 560 K inf/s at 25 MHz).

    layer_queries : optional per-layer query multiplicity (default 1 per
    layer); a conv layer is searched once per output position
    (`convnet.cnn_inference_cost` passes those counts).

    Energy: the macro draws its measured 0.8 mW whenever active, so
    E = P x latency (Table II's 703 M inf/s/W == 1.43 nJ/inf).
    """
    if layer_queries is None:
        layer_queries = [1] * len(layer_plans)
    if len(layer_queries) != len(layer_plans):
        raise ValueError("layer_queries/layer_plans length mismatch")
    cycles = 0
    searches = 0
    ops = 0
    for i, (plan, nq) in enumerate(zip(layer_plans, layer_queries)):
        passes = (n_output_passes if i == len(layer_plans) - 1 else 1) * nq
        cycles += plan.cycles_per_query * passes
        searches += plan.n_tiles * passes
        ops += (
            energy.ops_per_search(plan.rows, plan.row_bits)
            * plan.n_tiles * passes
        )
    # amortized re-tuning: one tune per threshold, spread over the batch
    tune_cycles = energy.tuning_cycles * n_output_passes / batch_per_tune
    cycles += int(math.ceil(tune_cycles))
    latency = cycles / energy.clock_hz
    return InferenceCost(
        cycles=cycles,
        searches=searches,
        binary_ops=ops,
        energy_j=energy.power_w * latency,
        latency_s=latency,
    )
