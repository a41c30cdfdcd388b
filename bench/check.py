"""The comparison that decides `correct`: the outputs the timed calls
returned, for a sample of the loop's calls drawn from the seed
(`loop.Reservoir`), against the plain reference on the same inputs,
weights and keys.  The cell's kind (`bench/kinds/<model>.py`) does the
comparing and gives each number beside its limit, which the cell's
workload file holds (`limits`); here `calls_compared` is added, which
must reach 1, so a run that compared nothing is not correct.
"""

from __future__ import annotations


def compare(setup, kept) -> dict:
    """{name: {"value", "limit", "rule"}} for the kept calls
    [(call, (row batch, key batch or None), output)]."""
    return {"calls_compared": {"value": len(kept), "limit": 1, "rule": ">="},
            **setup.kind.compare(setup, kept)}


def passed(checks: dict) -> bool:
    """Every number within its limit."""
    ok = True
    for c in checks.values():
        ok &= (c["value"] >= c["limit"] if c["rule"] == ">="
               else c["value"] <= c["limit"])
    return bool(ok)


def control_call(setup, control: str):
    """The reference with one departure (the kind's controls), shaped as
    the loop's call, to stand in the program's place."""
    return setup.kind.control_call(setup, control)
