"""The paper's binary classifiers as a kind of model (`model` "mlp"; "cnn"
takes the same functions, `kinds/cnn.py`): random deployed layers and the
input pool from `bench/model.py`, the system under test
`compile_pipeline`, the timed call `pipe.run(rows, spec[, keys=keys])`
returning int32 votes [B, classes], one inference a row, and the votes
compared with `bench/reference/bnn.py`.
"""

from __future__ import annotations

import time

import torch

from bench import model, roofline
from bench.reference import bnn as reference


def make(cfg: dict, traffic: dict, gen, device, log) -> dict:
    """Weights, the row pool and (where the spec takes per-row keys) the
    key words, drawn in that order from `gen`; the pipeline built on
    them, with the traffic's silicon noise model or none."""
    from repro_torch.spec import InferenceSpec

    spec = InferenceSpec(**traffic["spec"])
    t0 = time.perf_counter()
    net = model.make_net(cfg, gen)
    rows = model.make_rows(cfg, gen, traffic["pool_batches"],
                           traffic["batch"])
    keys = (model.make_keys(gen, traffic["key_batches"], traffic["batch"])
            if spec.needs_keys else None)
    t1 = time.perf_counter()
    noise = traffic.get("noise_model")
    pipe = model.build_pipeline(cfg, net, noise, device)
    log(f"set-up: weights, rows and keys {t1 - t0:.3f} s, "
        f"compile_pipeline {time.perf_counter() - t1:.3f} s")
    return dict(net=net, rows=rows, keys=keys, noise=noise, spec=spec,
                pipe=pipe)


def call(setup):
    """`run` through the pipeline's entry point."""
    pipe, spec = setup.pipe, setup.spec
    if spec.needs_keys:
        return lambda rows, keys: pipe.run(rows, spec, keys=keys)
    return lambda rows, keys: pipe.run(rows, spec)


def output(setup) -> tuple:
    """Votes [B, classes] int32."""
    classes = roofline.model_shapes(setup.cfg)["n_classes"]
    return (setup.rows.shape[1], classes), torch.int32


def units(setup) -> int:
    """One inference a row."""
    return setup.rows.shape[1]


def compare(setup, kept) -> dict:
    """`vote_cells_differing`: vote cells of the kept calls that differ
    from the reference's on the same rows, weights and keys."""
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
    return {"vote_cells_differing": {
        "value": differing,
        "limit": setup.traffic["limits"]["vote_cells_differing"],
        "rule": "<="}}


def control_call(setup, control: str):
    """The reference with one departure (`reference.CONTROLS`)."""
    def run(rows: torch.Tensor, keys):
        return reference.votes(setup.net, setup.cfg, rows, keys, setup.noise,
                               control=control)
    return run


def step_work(setup) -> roofline.Work:
    """`roofline.step` at the cell's batch, with the key words' bytes a
    row where the spec takes them."""
    keys = setup.keys
    key_bytes = 0 if keys is None else keys.shape[-1] * keys.element_size()
    return roofline.step(setup.cfg, setup.rows.shape[1], key_bytes)
