"""ms a train step of custom-100m, for comparing two trees, and the cost of
the chunked attention core taken apart.

    python scripts/torch_attention_ab.py [--src DIR] [--label NAME]
        [--reps 3] [--steps 20] [--core] [--profile]

Imports `repro_torch` from `--src` (default: this checkout's `src/`) and
times `chip_smoke.py` phase 8's first model: custom-100m (12 blocks,
d 768, 12 heads over 4 kv heads, float32, remat "none", attention one
key chunk at S = 512) through `make_train_step` at 8 x 512 with TF32
off; 3 untimed steps, then `--reps` times the mean ms of `--steps`
steps.  Prints the card's name and power limit, then one line
`ATTN-AB {"label": ..., "train_ms": [ms, ...], ...}`.

`--core` (a tree with `models.layers._chunked_attention`) adds, at the
same shapes, the attention core of one layer alone, forward + backward,
device ms (CUDA events, 20 calls after 3) and the peak bytes it
allocates, three ways: as the path runs it (one chunk through
`models.scan.scan_chunks`, rematerialised), the same chunk body under
plain autograd (no rematerialisation), and the one [B, G, R, S, S]
masked softmax the port had before chunking; and the decode core of one
llama3.2-1b layer (B = 4 over an 80-slot bf16 cache, phase 7's decode)
chunked and in the earlier float32-copy form, host µs a call (2,000
calls after 50: host-bound there).  `--profile` adds the 15 device
kernels that take most of one train step (`torch.profiler`), by total
device ms.

To compare a commit with the working tree on one card, unpack the
commit into a directory that `.gitignore` lists and run the trees in
turn, parent, change, change, parent, each in a process of its own:

    git archive HEAD | tar -x -C ab/parent
    for t in ab/parent/src src src ab/parent/src; do
        python scripts/torch_attention_ab.py --src $t --label $t; done
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 8, 512
NEG = -1e30


def device_ms(fn, n: int = 20) -> float:
    """Mean device ms a call over n calls after 3 untimed ones."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def peak_bytes(fn) -> int:
    """Bytes allocated at the peak of one call above those before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def call_us(fn, n: int = 2000) -> float:
    """Mean wall µs a call over n calls after 50 untimed ones."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def sxs_attention(q, k, v, q_pos, k_pos, window):
    """The port's form before chunking: one masked softmax over the
    [B, G, R, Sq, Sk] float32 scores.  q [B, G, R, Sq, dh]; k, v
    [B, G, Sk, dh]."""
    s = torch.einsum("bgrqd,bgcd->bgrqc", q.float() * q.shape[-1] ** -0.5,
                     k.float())
    delta = q_pos[:, None, None, :, None] - k_pos[:, None, None, None, :]
    valid = (delta >= 0) & (delta < window) & (
        k_pos[:, None, None, None, :] >= 0)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    return torch.einsum("bgrqc,bgcd->bgrqd", torch.softmax(s, -1),
                        v.float()).to(q.dtype)


def sxs_decode(qg, k_c, v_c, pos, pos_c, window, dtype):
    """The port's decode before chunking: the whole cache copied to
    float32, one softmax.  qg [B, G, R, 1, dh]; k_c, v_c [B, L, G, dh]."""
    qf = (qg.float() * qg.shape[-1] ** -0.5).to(qg.dtype)
    s = torch.einsum("bgrqd,blgd->bgrql", qf.float(), k_c.float())
    delta = pos[:, 0][:, None, None, None, None] - pos_c[:, None, None,
                                                         None, :]
    valid = (delta >= 0) & (delta < window) & (
        pos_c[:, None, None, None, :] >= 0)
    s = torch.where(valid, s, torch.full_like(s, NEG))
    p = torch.softmax(s, -1).to(dtype)
    return torch.einsum("bgrql,blgd->bgrqd", p.float(),
                        v_c.float()).to(dtype)


def core(cfg, dev) -> dict:
    """The attention core's three forms at the train shape and its two
    at the decode shape (see the module's docstring)."""
    from repro_torch.models import layers as L

    g = torch.Generator(dev).manual_seed(1)
    b, s, dh = BATCH, SEQ, cfg.d_model // cfg.n_heads
    gk, r = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    window = s
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)

    def leaf(*shape):
        return torch.randn(shape, generator=g, device=dev).requires_grad_()

    q, k, v = leaf(b, gk, r, s, dh), leaf(b, s, gk, dh), leaf(b, s, gk, dh)
    dout = torch.randn((b, gk, r, s, dh), generator=g, device=dev)
    chunk = min(cfg.attn_chunk, s)

    def path():
        out = L._chunked_attention(q * dh ** -0.5, k, v, pos, pos, window,
                                   chunk, q.dtype)
        torch.autograd.backward(out, dout)

    def no_remat():
        z = dict(dtype=torch.float32, device=dev)
        m = torch.full((b, gk, r, s), NEG, **z)
        l, acc = torch.zeros((b, gk, r, s), **z), torch.zeros(
            (b, gk, r, s, dh), **z)
        m, l, acc = L._attention_chunk(m, l, acc, q * dh ** -0.5, k, v,
                                       pos, pos, window)
        torch.autograd.backward(acc / l.clamp_min(1e-30)[..., None], dout)

    def sxs():
        out = sxs_attention(q, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
                            pos, pos, window)
        torch.autograd.backward(out, dout)

    train = {name: dict(ms=device_ms(fn), peak_bytes=peak_bytes(fn))
             for name, fn in (("chunked_remat", path),
                              ("chunk_no_remat", no_remat),
                              ("sxs_softmax", sxs))}

    # decode: llama3.2-1b's layer, B = 4 over an 80-slot bf16 cache
    from repro_torch import configs

    lc = configs.get_config("llama3.2-1b")
    b, slots, dh = 4, 80, lc.d_model // lc.n_heads
    gk, r = lc.n_kv_heads, lc.n_heads // lc.n_kv_heads
    bf = dict(generator=g, device=dev, dtype=torch.bfloat16)
    qg = torch.randn((b, gk, r, 1, dh), **bf)
    k_c, v_c = (torch.randn((b, slots, gk, dh), **bf) for _ in range(2))
    pos_c = torch.arange(slots, dtype=torch.int32, device=dev).expand(b, -1)
    here = torch.full((b, 1), slots - 1, dtype=torch.int32, device=dev)
    win = 1 << 30  # full attention, as the model passes it

    def dec_path():
        qf = (qg.float() * dh ** -0.5).to(qg.dtype).float()
        return L._chunked_attention(qf, k_c, v_c, here, pos_c, win,
                                    min(lc.attn_chunk, slots), qg.dtype)

    with torch.no_grad():
        decode = {"chunked_us": call_us(dec_path),
                  "f32_copy_us": call_us(lambda: sxs_decode(
                      qg, k_c, v_c, here, pos_c, win, qg.dtype)),
                  "chunked_device_ms": device_ms(dec_path, 200),
                  "f32_copy_device_ms": device_ms(lambda: sxs_decode(
                      qg, k_c, v_c, here, pos_c, win, qg.dtype), 200)}
    return dict(train_core_one_layer=train, decode_core_one_layer=decode,
                train_shape=[BATCH, SEQ, cfg.n_heads, cfg.n_kv_heads, dh],
                chunk=chunk)


def profile(step, state, batch) -> list:
    """The 15 device kernels that take most of one train step, by their
    total device ms, or [] where the profiler saw no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in p.key_averages():
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) / 1e3
        if ms > 0:
            rows.append(dict(name=e.key[:90], calls=e.count, device_ms=ms))
    return sorted(rows, key=lambda x: -x["device_ms"])[:15]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="src")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--core", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.launch.train import custom_100m
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; repro_torch from {args.src}", flush=True)
    dev = torch.device("cuda", 0)
    cfg = custom_100m()
    tcfg = TrainConfig()
    state = init_train_state(cfg, tcfg, torch.Generator(dev).manual_seed(0),
                             device=dev)
    step = make_train_step(cfg, tcfg)
    it = synthetic_stream(DataConfig(batch=BATCH, seq_len=SEQ,
                                     vocab_size=cfg.vocab_size))
    batch = next(it)
    for _ in range(3):
        state, _ = step(state, batch)
    train_ms = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        train_ms.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(f"  custom-100m {BATCH} x {SEQ}: ms a step {train_ms}", flush=True)
    out = {"label": args.label, "card": smi, "time": time.time(),
           "train_ms": train_ms, "loss": float(m["loss"])}
    if args.profile:
        out["profile_one_step"] = profile(step, state, batch)
        for row in out["profile_one_step"]:
            print(f"    {row['device_ms']:9.3f} ms {row['calls']:5d} x "
                  f"{row['name']}")
    del state, step
    torch.cuda.empty_cache()
    if args.core:
        out["core"] = core(cfg, dev)
        print(f"  core: {json.dumps(out['core'])}", flush=True)
    print("ATTN-AB " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
