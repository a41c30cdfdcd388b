"""PiC-BNN LM head serving demo on the PyTorch/CUDA port (the counterpart
of examples/picbnn_serve.py).

Serves musicgen-medium (reduced) through the decode path TWICE over the
same binary CAM match:
  1. "exact" readout — full-precision POPCOUNT per class (what an
     ADC/TDC-based processing-in-memory design reads out; the paper's
     competitor baseline), on the binary GEMM kernel,
  2. "votes" readout — PiC-BNN Algorithm 1: purely binary measurements
     across the threshold sweep, majority ranking, no ADC, on the CAM
     vote kernel.

Reports the greedy-decode agreement between the two readouts — the
LM-scale version of the paper's "binary votes recover the argmax" claim —
the pass-count sweep (Fig. 5 at LM scale), and the HBM-traffic saving of
the bit-packed head.

Runs on the CUDA card; `--device cpu` runs it on the CPU.  `main(argv)`
returns the numbers it prints (and, under "made", the streams, the
weights and the sweep heads).  `run` takes the weights and the sweep
heads, so the same computation runs on weights made anywhere.

Run:  PYTHONPATH=src python examples/torch_picbnn_serve.py [--device cpu]
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import binary_lm
from repro_torch.models import model as M
from repro_torch.pipeline import resolve_device

ARCH = "musicgen-medium+smoke"
B, S, STEPS = 4, 12, 16
PASSES = (9, 17, 33, 65, 129)


def frames(d_model: int):
    """The prompt embeddings [B, S, D] and the STEPS - 1 decode frames
    [B, 1, D], float32 from numpy seeds."""
    embeds = np.random.default_rng(0).normal(0, 1, (B, S, d_model))
    nxt = [np.random.default_rng(100 + t).normal(0, 1, (B, 1, d_model))
           for t in range(STEPS - 1)]
    return embeds.astype(np.float32), [f.astype(np.float32) for f in nxt]


def serve_streams(params, cfg_exact, cfg_votes, device) -> dict:
    """Greedy streams [B, STEPS] of both readouts on the same weights:
    prefill on the prompt embeddings, then a decode step a frame."""
    embeds, nxt = frames(cfg_votes.d_model)
    streams = {}
    for name, cfg in [("adc-exact-readout", cfg_exact),
                      ("picbnn-votes", cfg_votes)]:
        logits, cache = M.prefill(
            params, cfg, embeds=torch.from_numpy(embeds).to(device),
            max_len=S + STEPS)
        toks = [logits.argmax(-1).cpu().numpy()]
        for t, f in enumerate(nxt):
            lg, cache = M.decode(params, cfg, cache,
                                 torch.from_numpy(f).to(device), S + t)
            toks.append(lg.argmax(-1).cpu().numpy())
        streams[name] = np.stack(toks, 1)
    return streams


def sweep_hidden(d_model: int) -> np.ndarray:
    """The sweep's 256 hidden states [256, D], float32."""
    return np.random.default_rng(5).normal(0, 1, (256, d_model)).astype(
        np.float32)


def pass_sweep(heads: dict, cfg_votes, device) -> dict:
    """{passes: argmax agreement of the votes with the exact readout} on
    the sweep's hidden states, for each {passes: CamHead}."""
    h = torch.from_numpy(sweep_hidden(cfg_votes.d_model)).to(device)
    out = {}
    with torch.no_grad():
        for n_pass, ph in heads.items():
            c = dataclasses.replace(cfg_votes, cam_head_thresholds=n_pass)
            votes = binary_lm.cam_head_logits(ph, c, h)
            exact = binary_lm.cam_head_logits(
                ph, dataclasses.replace(c, cam_head_mode="exact"), h)
            out[n_pass] = float(
                (votes.argmax(-1) == exact.argmax(-1)).float().mean())
    return out


def sweep_heads(cfg_votes, device) -> dict:
    """{passes: CamHead}: each head's rows drawn from seed 0."""
    heads = {}
    for n_pass in PASSES:
        c = dataclasses.replace(cfg_votes, cam_head_thresholds=n_pass)
        ph = binary_lm.CamHead(c, device)
        ph.draw(torch.Generator(device=device).manual_seed(0))
        heads[n_pass] = ph
    return heads


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA unless asked
    cfg_votes = configs.get_config(ARCH + "+cam-head")
    cfg_exact = configs.get_config(ARCH + "+cam-head-exact")
    # identical weights for both readouts (one init, one seed)
    params = M.init_params(cfg_votes, torch.Generator(device=dev)
                           .manual_seed(0), device=dev)
    heads = sweep_heads(cfg_votes, dev)
    out = run(params, cfg_exact, cfg_votes, heads, dev)
    out["made"].update(params=params, heads=heads)
    return out


def run(params, cfg_exact, cfg_votes, heads: dict, device) -> dict:
    """The demo on given weights and sweep heads: prints the report and
    returns its numbers (the streams under "made")."""
    streams = serve_streams(params, cfg_exact, cfg_votes, device)
    for name, st in streams.items():
        print(f"[{name}] first stream: {st[0][:10].tolist()}")
    agree = float((streams["adc-exact-readout"]
                   == streams["picbnn-votes"]).mean())
    print(f"\ngreedy-decode agreement, ADC readout vs PiC-BNN votes: "
          f"{agree:.3f}")
    print("(every disagreement is a vote tie from the threshold-sweep "
          "quantization — the paper's precision/efficiency trade)")

    # Fig. 5 at LM scale: agreement grows with the pass count, as the
    # paper's accuracy grows with output-layer executions
    d, v = cfg_votes.d_model, cfg_votes.vocab_size
    print(f"\npass-count sweep (Fig. 5 analogue, {v}-way codebook):")
    sweep = pass_sweep(heads, cfg_votes, device)
    for n_pass, a in sweep.items():
        print(f"  {n_pass:4d} passes: argmax agreement {a:.3f}")

    dense_bytes = d * v * 2  # bf16 head read per token
    cam_bytes = d * v // 8  # bit-packed rows
    print(f"\nLM-head HBM traffic per decoded token: dense bf16 "
          f"{dense_bytes/1e6:.2f} MB vs packed CAM {cam_bytes/1e6:.3f} MB "
          f"({dense_bytes//cam_bytes}x less); prefill logits also skip "
          f"the vocab matmul's float32 accumulation")
    return {"device": str(device), "agreement": agree,
            "sweep": {str(k): a for k, a in sweep.items()},
            "dense_bytes": dense_bytes, "cam_bytes": cam_bytes,
            "made": {"streams": streams}}


if __name__ == "__main__":
    main()
