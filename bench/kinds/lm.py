"""A language model's prefill as a kind of model (`model` "lm"): the
program's `CausalLM` for the configuration's `arch`, drawn from the seed
through the program's own `init_params`, its MoE layers' expert bias
drawn after it, and a pool of prompts [pool, B, S] of token ids uniform
over the vocabulary; the timed call `models.model.prefill(params, cfg,
tokens)` (replayed from a CUDA graph, `prefill_graphed`) returning the
last position's float32 logits [B, V], B * S prompt tokens a call.

The comparison holds what ran layer by layer against
`bench/reference/lfm2.py` on the same weights: each kept call's prompts
are run again op by op with the residual stream recorded (`prefill`'s
`taps`), the replay's logits must equal the kept call's bit for bit (the
graph replays the same kernels), and each layer's operator and FFN, and
the head, are run by the reference on the replay's own input to that
layer.  A free-running comparison of the
logits cannot tell a fault from rounding here: in a random-weight
network of 24 layers with binary FFNs a bfloat16 rounding that flips a
BitLinear sign grows to an O(1) difference by the last layer, larger than
a routing fault's.
"""

from __future__ import annotations

import math
import time

import torch

from bench import lm_roofline
from bench.reference import lfm2 as reference


def _check_widths(mcfg, cfg: dict) -> None:
    """The program's configuration states the file's shapes."""
    got = (mcfg.d_model, mcfg.n_heads, mcfg.n_kv_heads, mcfg.d_ff,
           mcfg.expert_d_ff, mcfg.n_experts, mcfg.moe_top_k,
           mcfg.vocab_size, mcfg.n_layers, mcfg.conv_cache)
    want = tuple(cfg[k] for k in (
        "hidden_size", "num_attention_heads", "num_key_value_heads",
        "intermediate_size", "moe_intermediate_size", "num_experts",
        "num_experts_per_tok", "vocab_size", "num_hidden_layers",
        "conv_L_cache"))
    kinds = ["full_attention" if k == "attn" else "conv"
             for k in mcfg.pattern().kinds]
    if got != want or kinds != cfg["layer_types"]:
        raise ValueError(f"{mcfg.name} is not the file's model: {got} "
                         f"against {want}")


class Net:
    """The weights the reference reads (the program's state dict) and the
    replay of what the loop times, `(tokens, taps) -> logits`: the
    program, or a control in its place (set by `call` or
    `control_call`)."""

    def __init__(self, weights: dict):
        self.weights, self.replay = weights, None


def make(cfg: dict, traffic: dict, gen, device, log) -> dict:
    """The weights (`init_params` from `gen`, then each expert_bias
    normal x `assumed.expert_bias_std`), then the prompt pool, in that
    order from `gen`."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import init_params

    mcfg = get_config(cfg["arch"])
    _check_widths(mcfg, cfg)
    t0 = time.perf_counter()
    params = init_params(mcfg, gen, device)
    std = cfg["assumed"]["expert_bias_std"]
    with torch.no_grad():
        for name, buf in params.named_buffers():
            if name.endswith("expert_bias"):
                buf.copy_(torch.randn(buf.shape, generator=gen,
                                      device=gen.device) * std)
    rows = torch.randint(0, cfg["vocab_size"], (
        traffic["pool_batches"], traffic["batch"], traffic["seq"]),
        generator=gen, device=gen.device)
    log(f"set-up: weights and prompts {time.perf_counter() - t0:.3f} s")
    return dict(net=Net(dict(params.state_dict())), rows=rows, keys=None,
                noise=None, spec=mcfg, pipe=params)


def call(setup):
    """The program's prefill of a batch of prompts of one shape, as a
    serving step runs it (`prefill_graphed`: a CUDA graph replayed on the
    card, `prefill` op by op while spans are recorded), its cache sized
    to the prompt; the last position's logits.  The replay is `prefill`
    op by op with its taps, and keeps the program for the comparison."""
    from repro_torch.models.model import prefill, prefill_graphed

    params, mcfg, s = setup.pipe, setup.spec, setup.rows.shape[2]
    setup.net.replay = lambda tokens, taps: prefill(
        params, mcfg, tokens, max_len=s, taps=taps)[0]
    return lambda tokens, keys: prefill_graphed(params, mcfg, tokens,
                                                max_len=s)[0]


def output(setup) -> tuple:
    """Logits [B, V] float32."""
    return (setup.rows.shape[1], setup.cfg["vocab_size"]), torch.float32


def units(setup) -> int:
    """The call's prompt tokens: `inf_per_s` reads prompt tokens a
    second."""
    return setup.rows.shape[1] * setup.rows.shape[2]


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| over the whole tensor; not finite counts
    as infinitely far."""
    err = float((got - want).norm() / want.norm())
    return err if math.isfinite(err) else math.inf


def layer_errors(net: Net, cfg: dict, taps: list, logits) -> dict:
    """What ran, layer by layer, against the reference on its own input:
    {"operator", "dense_ffn", "moe": [each layer's ||what the sublayer
    added - the reference's on the same input|| / ||the reference's||],
    "head": [each row's ||logits - the reference head's on the last
    layer's output|| / ||the reference's||]}.  `taps` as `prefill`
    records them (each layer's input and its state after the operator,
    then the last output)."""
    out = {"operator": [], "dense_ffn": [], "moe": [], "head": []}
    for i in range(len(cfg["layer_types"])):
        w = reference.layer_weights(net.weights, i)
        h_in, h_mid, h_out = (t.float() for t in taps[2 * i:2 * i + 3])
        out["operator"].append(_rel(h_mid - h_in, reference.operator(
            w, cfg, i, h_in)))
        out["dense_ffn" if i < cfg["num_dense_layers"] else "moe"].append(
            _rel(h_out - h_mid, reference.ffn(w, cfg, i, h_mid)))
        del w
    want = reference.head(net.weights, cfg, taps[-1][:, -1].float())
    got = logits.float()
    out["head"] = [_rel(g, w) for g, w in zip(got, want)]
    return out


def compare(setup, kept) -> dict:
    """Each kept call's prompts replayed with the residual stream
    recorded: `replay_logit_diff` the largest |replayed - kept| logit
    (the replay is the timed computation: 0); then the largest error of
    any layer's operator, dense FFN and MoE, and of the head's rows, on
    the replay's own inputs (`layer_errors`)."""
    reference._no_tf32()
    limits = setup.traffic["limits"]
    worst = dict.fromkeys(("replay_logit_diff", "operator_rel_err_max",
                           "dense_ffn_rel_err_max", "moe_rel_err_max",
                           "head_rel_err_max"), 0.0)
    done = {}
    for _, (rb, _), got in kept:
        if rb not in done:
            taps = []
            with torch.no_grad():
                logits = setup.net.replay(setup.rows[rb], taps)
                errs = layer_errors(setup.net, setup.cfg, taps, logits)
            done[rb] = logits.float().cpu(), errs
            del taps, logits
        logits, errs = done[rb]
        diff = float((logits - got).abs().max())
        worst["replay_logit_diff"] = max(
            worst["replay_logit_diff"], diff if math.isfinite(diff)
            else math.inf)
        for part, values in errs.items():
            name = f"{part}_rel_err_max"
            worst[name] = max([worst[name], *values])
    return {name: {"value": value, "limit": limits[name], "rule": "<="}
            for name, value in worst.items()}


def control_call(setup, control: str):
    """The reference with one departure (`reference.CONTROLS`); the
    replay runs it again with its residual stream recorded."""
    weights, cfg = setup.net.weights, setup.cfg
    setup.net.replay = lambda tokens, taps: reference.forward(
        weights, cfg, tokens, control=control, taps=taps)
    return lambda tokens, keys: reference.forward(weights, cfg, tokens,
                                                  control=control)


def step_work(setup):
    """`lm_roofline.step` at the cell's prompts."""
    b, s = setup.rows.shape[1:]
    return lm_roofline.step(setup.cfg, b, s)
