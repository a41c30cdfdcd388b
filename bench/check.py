"""The comparison that decides `correct`: the votes the timed calls
returned, for a sample of the loop's calls drawn from the seed
(`loop.Reservoir`), against the plain reference on the same rows, weights
and keys.

Each number compared has its limit in the cell's workload file
(`limits`); `calls_compared` must reach 1, so a run that compared nothing
is not correct.
"""

from __future__ import annotations

import torch

from bench.reference import bnn as reference


def compare(setup, kept) -> dict:
    """{name: {"value", "limit", "rule"}} for the kept calls
    [(call, (row batch, key batch or None), votes)]."""
    hd, want = {}, {}
    differing = 0
    for _, (rb, kb), votes in kept:
        if rb not in hd:
            hd[rb] = reference.distances(setup.net, setup.cfg, setup.rows[rb])
        if (rb, kb) not in want:
            keys = None if kb is None else setup.keys[kb]
            want[rb, kb] = reference.votes_from(
                hd[rb], setup.net, setup.cfg, keys, setup.noise).cpu()
        differing += int((votes != want[rb, kb]).sum())
    limits = setup.traffic["limits"]
    return {
        "calls_compared": {"value": len(kept), "limit": 1, "rule": ">="},
        "vote_cells_differing": {"value": differing,
                                 "limit": limits["vote_cells_differing"],
                                 "rule": "<="},
    }


def passed(checks: dict) -> bool:
    """Every number within its limit."""
    ok = True
    for c in checks.values():
        ok &= (c["value"] >= c["limit"] if c["rule"] == ">="
               else c["value"] <= c["limit"])
    return bool(ok)


def control_call(setup, control: str):
    """The reference with one departure (`reference.CONTROLS`), shaped as
    the loop's call, to stand in the program's place."""
    def call(rows: torch.Tensor, keys):
        return reference.votes(setup.net, setup.cfg, rows, keys, setup.noise,
                               control=control)
    return call
