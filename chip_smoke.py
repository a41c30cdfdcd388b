"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure is caught and followed by
exit 0):

1. Print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from the sources in this checkout, timed, with ptxas' report.
2. Each kernel at the main path's shapes (the paper's MNIST 784-128-10 and
   Hand-Gesture 4096-128-20 nets, B = 4096) against its plain PyTorch
   version on the card: `torch.equal` is required.  Kernel time, plain
   time, and for kernel 1 the time of `torch._int_mm` on the unpacked ±1
   int8 operands (the same function, n - 2*HD; the port never calls it).
3. The main path, with every launch counter set to 0 just before it: the
   two nets (random weights from a numpy seed, fold-style parity-adjusted
   C, 64 bias cells, the paper's 33 thresholds) compiled on the card and
   run for votes, argmax and the noiseless cumulative staircase at
   B in {1, 100, 4096}; both nets registered in a `PicBnnServer` that
   answers a few hundred requests through `submit` and `submit_many`.
   Kernels 1 and 3 must have launched in this run.  Kernel 2 is not on
   this path (the reference's pipeline never calls it either); its own
   path is the public op `kernels.ops.cam_vote`, driven next on the two
   nets' head queries with the counts set to 0 just before it.
4. Correctness of what came out: the card's results equal the same
   pipelines on the CPU at every batch size and the digital oracle
   (folded_forward_exact + votes_fused) at B = 100; `ops.cam_vote`
   equals votes_fused; served votes equal direct `run`.
5. A `{"kernels": [...]}` line (launches on the kernel's path, error,
   times, bound), then, as the last line, `{"ok": true, "device": ...}`.

Without CUDA, or without the rest of the repository beside it, the script
exits non-zero before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
B_MAIN = 4096
MAIN_BATCHES = (1, 100, 4096)
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
POPC_PER_CLK_SM = 16  # __popc, compute capability 9.0 (CUDA C++ guide)
ALU_PER_CLK_SM = 64  # 32-bit add/xor/compare, compute capability 9.0
REPLACES = {
    "binary_gemm_hd": "src/repro/kernels/binary_gemm.py:72",
    "cam_vote": "src/repro/kernels/cam_search.py:72",
    "fused_mlp_votes": "src/repro/kernels/fused_mlp.py:160",
}
SOURCES = {
    "binary_gemm_hd": "src/repro_torch/kernels/csrc/binary_gemm.cu",
    "cam_vote": "src/repro_torch/kernels/csrc/cam_search.cu",
    "fused_mlp_votes": "src/repro_torch/kernels/csrc/fused_mlp.cu",
}


def require(cond: bool, what: str) -> None:
    """Stop the run, non-zero, when a check fails."""
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card (CUDA events, warmed up)."""
    for _ in range(2):
        fn()
    if not torch.cuda.is_available():  # a CPU rehearsal: host clock
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50, replays: int = 5):
    """Mean device milliseconds per call: `iters` calls captured in one
    CUDA graph, replayed, so the host's launch cost drops out.  None where
    the call cannot be captured (a CPU rehearsal)."""
    if not torch.cuda.is_available():
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: loads the library, sizes the allocator
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


class Card:
    """Peak rates of the card for the bound: SMs and max SM clock."""

    def __init__(self, sms: int, clock_hz: float):
        self.sms = sms
        self.clock_hz = clock_hz

    @classmethod
    def probe(cls) -> "Card":
        """This run's card: its SM count and nvidia-smi's max SM clock."""
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
        return cls(sms, clock)

    def bound_ms(self, popc: float, alu: float, nbytes: float):
        """Least time: the larger of the popcount pipe, the 32-bit ALU
        pipe and memory; returns (ms, "operations" | "bytes")."""
        t_ops = max(popc / POPC_PER_CLK_SM, alu / ALU_PER_CLK_SM) / (
            self.sms * self.clock_hz)
        t_mem = nbytes / MEM_BYTES_PER_S
        return (max(t_ops, t_mem) * 1e3,
                "operations" if t_ops >= t_mem else "bytes")


def random_folded(sizes, seed, bias_cells, bnn):
    """Random deployed net with fold-style parity-adjusted C_j."""
    rng = np.random.default_rng(seed)
    layers = []
    for n_in, n_out in zip(sizes[:-1], sizes[1:]):
        c = bnn.parity_adjust_c(
            rng.integers(-bias_cells, bias_cells + 1, n_out), n_in, bias_cells
        )
        layers.append(bnn.FoldedLayer(
            weights_pm1=rng.choice([-1, 1], (n_out, n_in)).astype(np.int8),
            c=c,
        ))
    return layers


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi("name,power.limit")
    print(f"card: {smi}")
    card = Card.probe()
    print(f"SMs {card.sms}, max SM clock {card.clock_hz / 1e6:.0f} MHz, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s "
          f"-> {_build.build_dir()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    kernels = run(torch.device("cuda", 0), B_MAIN, MAIN_BATCHES, card, smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, b_main: int, batches, card: Card,
        smi: str) -> list:
    """Phases 2-4 on `dev`; returns the kernels line's entries.

    Called with the card by `main`; a CPU rehearsal may call it with
    device "cpu" and small batches (every kernel then takes its plain
    version, so the kernel checks are trivially equal).
    """
    from repro_torch.configs.paper_mlp import HG_MLP, MNIST_MLP, PAPER_ENSEMBLE
    from repro_torch.core import binarize, bnn, ensemble
    from repro_torch.kernels import binary_gemm, cam_search, fused_mlp, ops
    from repro_torch.pipeline import compile_pipeline
    from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
    from repro_torch.spec import InferenceSpec

    on_card = dev.type == "cuda"
    # --------------------------------------------------- nets and pipelines
    models = {}
    for mid, cfg, seed in (("mnist", MNIST_MLP, SEED), ("hg", HG_MLP, SEED + 1)):
        folded = random_folded(cfg.layer_sizes, seed, cfg.bias_cells, bnn)
        models[mid] = dict(
            cfg=cfg, folded=folded,
            # no device argument: the entry point's default is the card
            gpu=compile_pipeline(folded, PAPER_ENSEMBLE,
                                 device=None if on_card else dev),
            cpu=compile_pipeline(folded, PAPER_ENSEMBLE, device="cpu"),
        )
    require(all(m["gpu"].device == dev for m in models.values()),
            "compile_pipeline() with no device did not land on the card")
    rng = np.random.default_rng(SEED + 7)
    for m in models.values():
        m["x"] = rng.choice([-1.0, 1.0], (b_main, m["cfg"].layer_sizes[0])
                            ).astype(np.float32)

    # ------------------------------------ kernels against their plain twins
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {k: {"per_model": {}} for k in REPLACES}
    for mid, m in models.items():
        pipe = m["gpu"]
        xp = binarize.pack_pm1(torch.from_numpy(m["x"]).to(dev))
        w1, c1, n1 = pipe.layer_ws[0], pipe.layer_cs[0], pipe.layer_n_bits[0]
        head, thr = pipe.head.cam.rows_packed, pipe.head.thresholds
        bias = pipe.head.bias_cells
        b, kw0 = xp.shape
        n_hidden, kw_h = w1.shape[0], head.shape[1]
        n_cls, p = head.shape[0], thr.shape[0]
        # head queries: the hidden activations with the bias drive bits
        hidden = bnn.folded_forward_exact(
            m["folded"][:1], torch.from_numpy(m["x"]).to(dev)) >= 0
        q = binarize.pack_bits(torch.cat(
            [hidden.to(torch.uint8),
             torch.ones((b, bias), dtype=torch.uint8, device=dev)], dim=-1))
        m["hidden_pm1"], m["q"] = hidden.float() * 2 - 1, q
        samples = torch.rand((b, n_cls, p), generator=gen, device=dev) \
            * (2 * float(thr.max()))
        thr_f = thr.float() + 0.5

        # kernel 1: layer-1 distances (the cumulative path's largest call)
        k1 = binary_gemm.binary_gemm_hd(xp, w1)
        k1_plain = binary_gemm.binary_gemm_hd_plain(xp, w1)
        require(torch.equal(k1, k1_plain), f"{mid}: binary_gemm_hd != plain")
        require(torch.equal(binary_gemm.binary_gemm_hd(q, head),
                            binary_gemm.binary_gemm_hd_plain(q, head)),
                f"{mid}: binary_gemm_hd (head) != plain")
        x_i8 = torch.from_numpy(m["x"]).to(dev, torch.int8)
        w_i8 = torch.from_numpy(m["folded"][0].weights_pm1).to(dev)
        # the library yardstick (n - 2*HD from int8 tensor cores); the
        # port never calls it, but it must compute the same function
        require(torch.equal(torch._int_mm(x_i8, w_i8.t()), n1 - 2 * k1),
                f"{mid}: torch._int_mm != n - 2*binary_gemm_hd")
        lib_ms = device_ms(lambda: torch._int_mm(x_i8, w_i8.t()))
        k1_call = time_ms(lambda: binary_gemm.binary_gemm_hd(xp, w1), 100)
        k1_ms = device_ms(lambda: binary_gemm.binary_gemm_hd(xp, w1))
        k1_plain_ms = time_ms(
            lambda: binary_gemm.binary_gemm_hd_plain(xp, w1), 3)
        pairs = b * n_hidden * kw0
        bound, by = card.bound_ms(pairs, 2 * pairs,
                                  4 * (b * kw0 + n_hidden * kw0 + b * n_hidden))
        report["binary_gemm_hd"]["per_model"][mid] = dict(
            shape=f"x[{b},{kw0}] w[{n_hidden},{kw0}]", ms=k1_ms,
            call_ms=k1_call,
            plain_ms=k1_plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms,
            max_abs_err=int((k1 - k1_plain).abs().max()))

        # kernel 2: the head vote, all three threshold forms
        errs = []
        for form, t, s in (("int", thr, None), ("float", thr_f, None),
                           ("sampled", thr, samples)):
            got = cam_search.cam_vote(q, head, t, thr_samples=s)
            want = cam_search.cam_vote_plain(q, head, t, thr_samples=s)
            require(torch.equal(got, want), f"{mid}: cam_vote[{form}] != plain")
            errs.append(int((got - want).abs().max()))
        k2_call = time_ms(lambda: cam_search.cam_vote(q, head, thr), 100)
        k2_ms = device_ms(lambda: cam_search.cam_vote(q, head, thr))
        k2_plain_ms = time_ms(
            lambda: cam_search.cam_vote_plain(q, head, thr), 3)
        pairs = b * n_cls * kw_h
        bound, by = card.bound_ms(pairs, 2 * pairs + 2 * b * n_cls * p,
                                  4 * (b * kw_h + n_cls * kw_h + p + b * n_cls))
        report["cam_vote"]["per_model"][mid] = dict(
            shape=f"q[{b},{kw_h}] rows[{n_cls},{kw_h}] P={p}", ms=k2_ms,
            call_ms=k2_call,
            plain_ms=k2_plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, max_abs_err=max(errs))

        # kernel 3: the whole net, all three threshold forms
        args = (xp, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits, head)
        errs = []
        for form, t, s in (("int", thr, None), ("float", thr_f, None),
                           ("sampled", thr, samples)):
            got = fused_mlp.fused_mlp_votes(*args, t, bias_cells=bias,
                                            thr_samples=s)
            want = fused_mlp.fused_mlp_votes_plain(*args, t, bias_cells=bias,
                                                   thr_samples=s)
            require(torch.equal(got, want),
                    f"{mid}: fused_mlp_votes[{form}] != plain")
            errs.append(int((got - want).abs().max()))
        k3_call = time_ms(lambda: fused_mlp.fused_mlp_votes(
            *args, thr, bias_cells=bias), 100)
        k3_ms = device_ms(lambda: fused_mlp.fused_mlp_votes(
            *args, thr, bias_cells=bias))
        k3_plain_ms = time_ms(lambda: fused_mlp.fused_mlp_votes_plain(
            *args, thr, bias_cells=bias), 3)
        pairs = b * (n_hidden * kw0 + n_cls * kw_h)
        alu = 2 * pairs + 3 * b * n_hidden + 2 * b * n_cls * p
        nbytes = 4 * (b * kw0 + n_hidden * kw0 + n_hidden + n_cls * kw_h + p
                      + b * n_cls)
        bound, by = card.bound_ms(pairs, alu, nbytes)
        report["fused_mlp_votes"]["per_model"][mid] = dict(
            shape=f"x[{b},{kw0}] {m['cfg'].layer_sizes} P={p}", ms=k3_ms,
            call_ms=k3_call,
            plain_ms=k3_plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, max_abs_err=max(errs))
        for k, r in report.items():
            row = r["per_model"][mid]
            print(f"  {mid:5s} {k:16s} {row['shape']}: kernel "
                  f"{row['ms']} ms (call {row['call_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
                  f"{row['library_ms']}")

    # ------------------- end to end: one run() call, input already on dev
    e2e = {}
    for mid, m in models.items():
        for bsz in batches:
            xd = torch.from_numpy(m["x"][:bsz]).to(dev)
            for sname, spec in (("votes", InferenceSpec()),
                                ("cumulative", InferenceSpec(cumulative=True))):
                ms = time_ms(lambda: m["gpu"].run(xd, spec), 20)
                e2e[f"{mid}/B={bsz}/{sname}"] = dict(ms=ms,
                                                     inf_per_s=bsz / ms * 1e3)
                print(f"  run {mid:5s} B={bsz:5d} {sname:10s}: {ms:.4f} ms "
                      f"-> {bsz / ms * 1e3:,.0f} inf/s")
    print(json.dumps({"e2e": e2e, "card": smi}))

    # ------------------------------------------------------ the main path
    specs = {"votes": InferenceSpec(),
             "argmax": InferenceSpec(reduction="argmax"),
             "cumulative": InferenceSpec(cumulative=True)}
    counted = (binary_gemm.binary_gemm_hd, cam_search.cam_vote,
               fused_mlp.fused_mlp_votes)
    for fn in counted:
        fn.launches = 0
    results = {}
    t0 = time.perf_counter()
    for mid, m in models.items():
        for bsz in batches:
            for sname, spec in specs.items():
                results[(mid, bsz, sname)] = m["gpu"].run(m["x"][:bsz], spec)
    policy = BatchingPolicy(max_batch=256, max_wait_us=500)
    served = {}
    server = PicBnnServer(policy, devices=None if on_card else [dev])
    for mid, m in models.items():
        server.register(mid, m["gpu"])
    server.warmup()
    with server:
        singles = {mid: [server.submit(mid, m["x"][i]) for i in range(100)]
                   for mid, m in models.items()}
        bursts = {mid: server.submit_many(mid, m["x"][100:400])
                  for mid, m in models.items()}
        for mid in models:
            served[mid] = np.concatenate(
                [np.stack([h.result(timeout=60).votes
                           for h in singles[mid]]),
                 bursts[mid].votes_all(timeout=60)])
    if on_card:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    stats = server.stats()
    print(f"main path: {main_s:.2f} s, launches {launches}")
    print(stats.summary())
    for fn in (binary_gemm.binary_gemm_hd, fused_mlp.fused_mlp_votes):
        # (a CPU rehearsal launches nothing)
        require(launches[fn.__name__] > 0 or not on_card,
                f"{fn.__name__} was not launched on the main path")

    # ------------------- kernel 2's own path: the public op ops.cam_vote
    for fn in counted:
        fn.launches = 0
    op_votes = {mid: ops.cam_vote(m["q"], m["gpu"].head.cam.rows_packed,
                                  m["gpu"].head.thresholds)
                for mid, m in models.items()}
    if on_card:
        torch.cuda.synchronize()
    op_launches = {fn.__name__: fn.launches for fn in counted}
    print(f"ops.cam_vote path: launches {op_launches}")
    require(op_launches["cam_vote"] > 0 or not on_card,
            "cam_vote was not launched on its path (ops.cam_vote)")
    require(stats.n_requests == 2 * 400,
            f"server answered {stats.n_requests} of {2 * 400} requests")

    # -------------------------------------------- correctness of the output
    for mid, m in models.items():
        for bsz in batches:
            for sname, spec in specs.items():
                got = results[(mid, bsz, sname)]
                want = m["cpu"].run(m["x"][:bsz], spec)
                require(got.device == dev
                        and tuple(got.shape) == tuple(want.shape),
                        f"{mid} B={bsz} {sname}: shape {tuple(got.shape)}")
                require(torch.equal(got.cpu(), want),
                        f"{mid} B={bsz} {sname}: card != CPU pipeline")
        x100 = torch.from_numpy(m["x"][:100])
        h = torch.where(bnn.folded_forward_exact(m["folded"][:-1], x100) >= 0,
                        1.0, -1.0)
        oracle = ensemble.votes_fused(m["cpu"].head, h)
        require(torch.equal(results[(mid, 100, "votes")].cpu(), oracle),
                f"{mid}: votes != folded_forward_exact + votes_fused oracle")
        require(torch.equal(
            op_votes[mid].cpu(),
            ensemble.votes_fused(m["cpu"].head, m["hidden_pm1"].cpu())),
            f"{mid}: ops.cam_vote != votes_fused")
        direct = m["gpu"].run(m["x"][:400], specs["votes"]).cpu().numpy()
        require(np.array_equal(served[mid], direct),
                f"{mid}: served votes != direct run")
        print(f"  {mid}: card == CPU at B={batches}, == oracle at "
              f"B=100, served == direct for 400 requests")

    # ------------------------------------------------------------ summary
    line = []
    for name, r in report.items():
        main = r["per_model"]["hg"]
        op_path = name == "cam_vote"  # not on the main path (phase 3)
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            path=("kernels.ops.cam_vote" if op_path
                  else "pipeline run + server"),
            launches=(op_launches if op_path else launches)[name],
            main_path_launches=launches[name],
            equal=True, max_abs_err=max(
                v["max_abs_err"] for v in r["per_model"].values()),
            ms=main["ms"], kernel_ms=main["ms"], call_ms=main["call_ms"],
            plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], shape=main["shape"],
            per_model=r["per_model"], card=smi,
        ))
    return line


if __name__ == "__main__":
    sys.exit(main())
