"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure is caught and followed by
exit 0):

1. Print the card's name and power limit (nvidia-smi), build the CUDA
   kernels from the sources in this checkout, timed, with ptxas' report
   (registers, spills, shared memory) and each library's tensor-core
   instructions in its SASS (`cuobjdump -sass`: IMMA, BMMA); the four
   kernel libraries must hold some (the keyed sampler's, the expert and
   row kernels' and the input packing's hold none: they draw, scale or
   compare, they do not multiply).
2. Each kernel at the main path's shapes against its plain PyTorch
   version on the card: `torch.equal` is required.  Kernels 1-3 at the
   paper's MNIST 784-128-10 and Hand-Gesture 4096-128-20 MLPs, kernel 4
   (`fused_conv_votes`, and its stage entry `conv_stage_packed`) at the
   paper's MNIST and HG CNNs (`configs/paper_cnn.py`, full width and
   depth: two 3x3x32 stride-2 convs + FC 128), all at B = 4096 with the
   three threshold forms, and kernel 4 also at the unaligned (24 -> 20
   channels, stride 1) and head-direct test configs.  Kernel 1 also at
   the shapes the CNNs' cumulative staircase gives it (the stage entry's
   query against the FC rows, then the head query).  Kernel time, plain
   time, and for kernel 1 the time of `torch._int_mm` on the unpacked ±1
   int8 operands (the same function, n - 2*HD; the port never calls it),
   for kernel 2 at the MLP heads a float32 ±1 `torch.matmul` of the
   unpacked operands and the threshold compare (held equal to it).
   Each time stands beside the previous version's and beside its bound:
   the least time over the popcount route and the int8 and 1-bit
   tensor-core routes, each the larger of its operations and its bytes
   (`Card.bound_ms`).
   Then `run()` per call at each batch size, and the CNN input layer
   (`InputEncoding.pack`) alone at B = 4096, in a `{"e2e": ...}` line,
   and one `torch.profiler` pass over the HG MLP's `run()` at B = 4096
   that splits the call into device-kernel time and the rest, in a
   `{"profile": ...}` line.
3. The main path, with every launch counter set to 0 just before it: the
   two MLPs and the two CNNs (random weights from numpy seeds,
   fold-style parity-adjusted C, 64 bias cells, the paper's 33
   thresholds) compiled on the card with no device argument and run for
   votes, argmax and the noiseless cumulative staircase at
   B in {1, 100, 4096}; all four registered in one `PicBnnServer` that
   answers a few hundred requests each through `submit` and
   `submit_many`.  Kernels 1, 3 and 4 (both entries) must have launched
   in this run.  Kernel 2 is not on this path (the reference's pipeline
   never calls it either); its own path is the public op
   `kernels.ops.cam_vote`, driven next on the two MLPs' head queries with
   the counts set to 0 just before it, and the LM's CAM head (phase 7).
4. Correctness of what came out: the card's results equal the same
   pipelines on the CPU at every batch size and the digital oracles
   (folded_forward_exact + votes_fused for the MLPs, `conv_votes_ref`
   for the CNNs) at B = 100; `ops.cam_vote` equals votes_fused; served
   votes equal direct `run`.
5. Silicon mode, with every launch counter set to 0 just before it: the
   four models compiled with noise=SILICON (no device argument), run at
   B in {1, 100, 4096} for noise="batch" votes and argmax (kernels 3 and
   4 with the sampler's [B, C, P] thresholds) and per-request votes and
   MC-8 sums (head distances once: kernel 1, after the stage entry for
   the CNNs), noisy cumulative at B = 100, an HG MLP with a calibrated
   (float) head, NOISELESS pipelines on every noisy spec, and one server
   with a silicon MLP and a silicon CNN answering 400 keyed requests
   each.  Kernels 1, 3, 4, the stage entry and the keyed sampler must
   have launched.
   Checks: batch votes equal the CPU pipeline's distances against the
   samples replayed from the generator state (the CNNs at B = 4096
   against the card's own distances), per-request votes equal the card's
   own compare of its keyed samples (card-vs-CPU agreement printed),
   NOISELESS equals the noiseless votes, calibrated card equals CPU,
   served equals direct.  Then the sampled-form kernels and the sampler
   timed at B = 4096 and `run()` per silicon spec, and the keyed
   sampler's kernel (`keyed_thresholds`) against its plain version
   (`torch.equal`) at the HG head (P = 33, 20 rows) at B = 32,768 (the
   benchmark's silicon cells) and 4096: kernel, call and plain ms beside
   its bound, in a `{"silicon": ...}` line.
6. Training, with every launch counter set to 0 just before its path:
   synthetic data (`data.synthetic`, 8,000 train / 1,000 test images a
   task); the MNIST 784-128-10 and HG 4096-128-20 MLPs trained on the
   card for 10 epochs and the MNIST and HG CNNs for 3 (`train_mlp`,
   `train_cnn`: batch 128, lr 2e-3), each saved every epoch with
   `AsyncCheckpointer` and the last save restored and held equal to the
   live params; ms per step and steps/s; software top-1
   (`eval_accuracy`); then `deploy_mlp`/`deploy_cnn` of the trained
   params with no device argument, `run(VOTES)`/`run(PREDICT)` on the
   test set through kernels 3 and 4, and a server with the four trained
   Deployments (Table-II rates: derived for the MLPs, `silicon_cost=`
   for the CNNs) answering 300 requests each.  Kernels 3 and 4 must have
   launched.  Checks: one gradient step of each model at full width,
   card against CPU within GRAD_TOL (cuDNN TF32 off for it); trained
   votes on the card equal to the CPU pipeline's, PREDICT to their
   argmax; end-to-end-binary top-1 >= software top-1 - 0.05; served ==
   direct; the MNIST MLP's 784-bit layer through `mapping.layer_forward`
   (four 256-bit tiles, exact and hierarchical) card == CPU, with both
   accuracies through `ensemble.predict`; `ops.binary_gemm_mxu`
   (`torch._int_mm`) == its plain version at M in {1, 15, 17, 4096} and
   K outside 8Z; Table II from `model_inference_cost` /
   `cnn_inference_cost`, labelled as the 65 nm macro's model, the MNIST
   MLP's inside the paper's band.  A `{"train": ...}` line.
7. The LM serving path, with every launch counter set to 0 just before
   it: llama3.2-1b at full width and depth (16 blocks, bf16, vocab
   128,256) plain, +binary-ffn (the BitLinear FFN on kernel 1) and
   +cam-head (Algorithm 1 as the decode head on kernel 2), each through
   `Engine.generate` (8 requests, prompt 16, 16 new tokens, batches of
   4, no device argument); musicgen-medium+cam-head at full width and
   depth through `prefill_step`/`decode_step` on random frame
   embeddings; mixtral-8x7b and falcon-mamba-7b at full width, 2 blocks,
   through `Engine.generate`.  Kernels 1 and 2 must have launched.
   Checks: each kernel `torch.equal` to its plain version and to the
   library's float32 ±1 product at every LM shape of the path (kernel 2
   at C = 128,256), on the models' packed rows, and at the launch plans'
   edges (kernel 2 at B = 1, 16, 17, 32 on the CAM head's rows, kernel 1
   at each plan's boundary on random words); teacher-forced decode
   logits within LM_ATOL (LM_ATOL_BITLINEAR with a BitLinear FFN) of
   `forward`; the engine's tokens equal to the teacher-forced argmax and
   to forward's where its margin exceeds twice the tolerance;
   llama3.2-1b at full width, 2 blocks, float32, and its BitLinear
   projections: card == CPU.  Prefill ms, decode ms a token, tokens/s,
   and each kernel's device ms at the LM shapes beside its bound and the
   library's time, in a `{"lm": ...}` line; the previous version's times
   (`LM_PREV_MS`, `LM_PREV_DECODE_MS`) are printed beside them, never put
   in a JSON line.  Then the custom ops'
   dispatch (kernels 1 and 2 are `torch.library` custom ops): each op
   against its ctypes launch called straight, a call at the decode
   shapes, and decode ms a token of +binary-ffn, +cam-head and the plain
   model with the launches called straight and through the ops,
   alternating.  Then the long context (`lm_long_phase`), counts from 0:
   llama3.2-1b+binary-ffn+cam-head at full width and depth prefills one
   sequence of 32,768 tokens through `prefill_step` (attention in key
   chunks of `attn_chunk`) and decodes 4 tokens over that cache (read
   in its bf16 layout a chunk at a time); kernel 1 must launch in the
   prefill and every decode step, kernel 2 in every decode step.
   Prefill seconds, decode ms a token and `max_memory_allocated` beside
   one layer's S x S float32 score bytes.  Kernels 1 and 2 on the
   operands of their first call of each shape on that path (BitLinear
   at M = 32,768 and M = 1, the CAM head at B = 1) == their plain
   versions and the library call, with their times.  llama3.2-1b at 2
   blocks, float32, prefill 2,048 + 4 decode steps, card == CPU within
   LM_F32_ATOL + LM_F32_RTOL |cpu|.  An `{"lm_long": ...}` line.
8. LM training, with every launch counter set to 0 just before its
   path: the reference's 100M example (custom-100m, float32, 300 steps
   of 8 x 512 through `launch.train` with the Supervisor and a
   checkpoint every 50 steps; the loss must fall), then llama3.2-1b+
   binary-ffn at full width and depth (bf16, remat full, 10 steps of
   8 x 256), served afterwards through `Engine.generate` (phase 7's
   workload), which puts kernel 1 on the trained weights.  Kernel 1
   must have launched, and no kernel inside the training steps (the
   BitLinear training form is the float ±1 product, as the
   reference's).  Checks: kernel 1 == plain == library at the trained
   model's shapes; its tokens against teacher-forced decode and forward
   (phase 7's rule); its forward as served (kernel 1 in all 16 blocks)
   bit-equal to the float ±1 training form; one step of llama3.2-1b at
   2 blocks in float32 at lr 3e-4, card against CPU (loss, grad norm,
   every gradient, m and v leaf, the update where |g| >= 1e3 * eps);
   EF-signSGD card against CPU and three compressed steps; mixtral-8x7b
   (1 block, 4 x 128) and falcon-mamba-7b (2 blocks, 4 x 512: two
   rematerialised scan chunks) at full width, three steps each, with
   their peak memory; examples/ft_demo.py's scenario (failures at 13 and 27, a
   straggler at 31-35) under deterministic algorithms, final state ==
   the failure-free run's.  ms a step, tokens/s, peak memory and the
   losses in an `{"lm_train": ...}` line.
9. The sharding layer on one card, a (1, 1) mesh, with every launch
   counter set to 0 just before each sharded path: the four paper
   classifiers through `PicBnnServer(fanout="spmd")` (over the card, and
   over two slices of it), kernels 3 and 4 required, predictions ==
   round-robin (phase 3) == a direct `run`, device -1 on each result;
   `launch.serve --model-parallel 1` on llama3.2-1b+binary-ffn with the
   CAM head at full width and depth (DTensor parameters, one NCCL rank),
   kernels 1 and 2 required on the local shards and == their plain
   versions on the packed rows the sharded path made, tokens == the
   same launcher without a mesh; `launch.train --model-parallel 1` on
   llama3.2-1b at 2 blocks, float32: one step == the unsharded step
   within phase 8's tolerances.  Decode ms a token and train ms a step,
   mesh against none (the DTensor layer's cost), in a `{"mesh": ...}`
   line.
10. The dry-run tooling (`repro_torch.launch.dryrun`): (a) full-size
   cells traced on fake production meshes, each `python -m
   repro_torch.launch.dryrun` call a subprocess (llama3.2-1b train_4k,
   prefill_32k and decode_32k on 16 x 16, mixtral-8x7b decode_32k on
   2 x 16 x 16, llama3.2-1b+binary-ffn+cam-head decode_32k with kernels
   1 and 2 in their fake forms), each "ok", with peak GiB a device, the bottleneck, the roofline's three
   terms and the trace's seconds; (b) two of phase 9's (1, 1)-mesh runs
   (the served model's decode step at B = 4, the 2-block float32 train
   step) and a falcon-mamba-7b train step (2 blocks, float32, 2 x 512:
   two scan chunks) run on the card under the dry-run's counter, the
   counts set to 0 just before, against the same cells traced on a fake
   (1, 1) group (there one scan chunk runs, charged twice): FLOPs, binary operations, HBM
   bytes and collectives equal, argument bytes equal, the peak estimate
   within DRY_PEAK_RTOL of `torch.cuda.max_memory_allocated`, the
   roofline bound as a fraction of a warm step (timed once the dry-run
   subprocesses have ended); kernels 1 and 2 launched
   in the decode step through their custom ops and equal to their plain
   versions on the rows it packed.  A `{"dryrun": ...}` line.
11. The four examples (`examples/torch_*.py`: quickstart at --fast,
   picbnn_serve, lm_train at --preset tiny, ft_demo), each through its
   `main()` in this process with no device argument, every launch
   counter set to 0 just before the first.  Kernels 3 and 4 must launch
   in the quickstart (its MLP and CNN deployments and servers), kernels
   2 and 1 in picbnn_serve (the CAM head's votes and exact readouts).
   Every kernel call of the phase is caught: each kernel called at least
   as often as it launched, and on the operands of its first call of
   each form equal to its plain version, timed beside its bound.
   Checks: the quickstart's noiseless votes and predictions on the card
   equal the same `Deployment` run on the CPU (MLP and CNN) and its
   served predictions the direct ones; picbnn_serve's vote and exact streams
   and pass sweep equal the same computation on the CPU on the same
   weights; lm_train's 60 losses are finite; ft_demo restarts twice and
   ends on the failure-free run's parameters.  Each example's wall
   seconds and launches in an `{"examples": ...}` line.
12. LFM2-8B-A1B's prefill kernels (`lfm2_phase`): kernel 1's grouped
   entry (`grouped_bitlinear_hd`), SwiGLU-and-signs and the combine
   (`kernels/expert_ffn.py`), the RMS norm and a BitLinear input's signs
   (`kernels/rows.py`), each at the benchmark cell's shapes (2 prompts x
   2,048 tokens: 16,384 routed slots over 32 experts at ragged loads, one
   expert with none; gate and up N 3,584 at K 2,048, down N 2,048 at K
   1,792; [4,096, 2,048] bfloat16 rows) against its plain version on the
   card: distances and sign bits equal, the norms and betas within their
   last bfloat16 bit, the combine equal; device ms a launch beside the
   bound (bytes, or kernel 1's 1-bit products).  Then the model at its
   published widths (`lfm2-8b-a1b+binary-ffn`, random weights), every
   counter set to 0 just before one `prefill` of the cell's prompts: each
   kernel launched as often as its layers ask (2 grouped launches, one
   SwiGLU, one combine and one sign pass a MoE layer; an RMS norm a
   sublayer norm, a QK norm and the final norm), and the call's ms at 2
   and 4 prompts, op by op and replayed from a CUDA graph
   (`prefill_graphed`), in an `{"lfm2": ...}` line.
13. The input packing (`pack_phase`, callable alone): both entries of
   `kernels/pack_input.py`, the ±1 sign pack (`sign_words`) and the
   thermometer code (`threshold_words`), at the HG cells' shapes (32,768
   rows of 4,096 float32, thermometer-4) and MNIST's (784, thermometer-8)
   equal to their plain twins (`binarize.pack_pm1`,
   `InputEncoding.pack`) on the card, device ms a launch beside the bytes
   bound (the float32 rows read, the words written) and the plain twin's
   ms; then one `run` of an HG MLP and an HG CNN pipeline at 32,768 rows
   launches each entry once; a `{"pack": ...}` line.
14. A `{"kernels": [...]}` line (launches on the kernel's path, on the
   silicon, train, LM, long-context, LM-training, mesh, dry-run and
   examples paths, error, times, sampled-form times, bound, the LM-shape,
   long-context and examples rows; the LFM2 prefill's kernels with their
   launches a call, error, time and bound; the input packing's entries
   with their launches a `run` call and on the main path, which must
   launch both), then, as the last line,
   `{"ok": true, "device": ...}`.

Without CUDA, or without the rest of the repository beside it, the script
exits non-zero before printing any result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
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
# dense int8 tensor-core MACs: 1,979 TOPS at 1.83 GHz on 132 SMs (data sheet)
INT8_MACS_PER_CLK_SM = 4096
# 1-bit products: unpublished; `mma.sync .b1` issues at the int8 rate with
# 8x the bits (scripts/torch_mma_probe.py), so 8x the int8 peak
B1_MACS_PER_CLK_SM = 8 * INT8_MACS_PER_CLK_SM
# device times of the kernels' previous version (NVIDIA H100 80GB HBM3,
# 700 W), HG (MNIST), printed beside this run's as "prev"
PREV_MS = {"cam_vote": (0.0049, 0.0049), "fused_mlp_votes": (0.0567, 0.0129),
           "binary_gemm_hd": (0.0067, 0.0055),
           "fused_conv_votes": (0.1480, 0.0344),
           "conv_stage_packed": (0.1362, 0.0301)}
# every kernel's library must hold tensor-core products
TENSOR_CORE_LIBS = ("binary_gemm", "cam_search", "fused_mlp", "fused_conv")
REPLACES = {
    "binary_gemm_hd": "src/repro/kernels/binary_gemm.py:72",
    "cam_vote": "src/repro/kernels/cam_search.py:72",
    "fused_mlp_votes": "src/repro/kernels/fused_mlp.py:160",
    "fused_conv_votes": "src/repro/kernels/fused_conv.py:302",
    # kernel 4's device code stopped after the flatten: what the
    # reference's cumulative path gets from the XLA twin at :208
    "conv_stage_packed": "src/repro/kernels/fused_conv.py:302",
}
SOURCES = {
    "binary_gemm_hd": "src/repro_torch/kernels/csrc/binary_gemm.cu",
    "cam_vote": "src/repro_torch/kernels/csrc/cam_search.cu",
    "fused_mlp_votes": "src/repro_torch/kernels/csrc/fused_mlp.cu",
    "fused_conv_votes": "src/repro_torch/kernels/csrc/fused_conv.cu",
    "conv_stage_packed": "src/repro_torch/kernels/csrc/fused_conv.cu",
    "keyed_thresholds": "src/repro_torch/kernels/csrc/keyed_sampler.cu",
    "grouped_bitlinear_hd": "src/repro_torch/kernels/csrc/binary_gemm.cu",
    "expert_swiglu_signs": "src/repro_torch/kernels/csrc/expert_ffn.cu",
    "expert_combine": "src/repro_torch/kernels/csrc/expert_ffn.cu",
    "rms_norm_rows": "src/repro_torch/kernels/csrc/rows.cu",
    "sign_rows": "src/repro_torch/kernels/csrc/rows.cu",
    "sign_words": "src/repro_torch/kernels/csrc/pack_input.cu",
    "threshold_words": "src/repro_torch/kernels/csrc/pack_input.cu",
}
# the keyed sampler's work a normal (csrc/keyed_sampler.cu): Threefry-2x32-20
# in 32-bit ALU operations (20 rounds of add, funnel-shift, xor and the key
# injections), and an estimate of Box-Muller's float64 operations (one
# libdevice log, cos and sqrt)
THREEFRY_ALU_OPS = 80
BOX_MULLER_FP64_OPS = 80
FP64_PER_CLK_SM = 64  # float64 FMA lanes, compute capability 9.0


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


def profile_split(fn, iters: int) -> dict:
    """One `torch.profiler` pass over `iters` calls: per call, the wall
    time (host clock, ending in a synchronize), the device-kernel time
    (the CUDA kernel events' durations) and the rest, with the kernels by
    name.  On a CPU rehearsal the device side is empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e3 / iters
    dev_ms = sum(kernels.values())
    return dict(call_ms=wall_ms, device_kernel_ms=dev_ms,
                rest_ms=wall_ms - dev_ms,
                device_share=dev_ms / wall_ms if wall_ms else None,
                kernels=dict(sorted(kernels.items(), key=lambda kv: -kv[1])))


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

    def bound_ms(self, popc: float, alu: float, nbytes: float,
                 macs: float, alu_tc: float):
        """Least time for a function over the routes that compute it: the
        popcount route (`popc` popcounts and `alu` 32-bit ALU operations)
        and the tensor-core routes (`macs` bit products at the int8 or the
        1-bit rate, with `alu_tc` ALU operations beside them); each route
        takes the larger of its operations and its `nbytes` of memory.
        Returns (ms, "popcount" | "tensor cores" | "bytes", {route: ms})."""
        clk = self.sms * self.clock_hz
        ops = {
            "popcount": max(popc / POPC_PER_CLK_SM, alu / ALU_PER_CLK_SM),
            "int8 tensor cores": max(macs / INT8_MACS_PER_CLK_SM,
                                     alu_tc / ALU_PER_CLK_SM),
            "b1 tensor cores": max(macs / B1_MACS_PER_CLK_SM,
                                   alu_tc / ALU_PER_CLK_SM),
        }
        t_mem = nbytes / MEM_BYTES_PER_S
        routes = {k: max(v / clk, t_mem) * 1e3 for k, v in ops.items()}
        best = min(ops, key=ops.get)
        by = ("bytes" if t_mem >= ops[best] / clk
              else "popcount" if best == "popcount" else "tensor cores")
        return min(routes.values()), by, routes


def bound_fields(card: Card, *work) -> dict:
    """A row's bound keys: `bound_ms`, `bound_by` ("bytes" or
    "operations"), `bound_route` (the route that sets it: "popcount",
    "tensor cores" or "bytes") and each route's time."""
    ms, route, routes = card.bound_ms(*work)
    return dict(bound_ms=ms,
                bound_by="bytes" if route == "bytes" else "operations",
                bound_route=route, bound_routes=routes)


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


def threshold_forms(thr, b, n_cls, gen, dev):
    """The three threshold forms of a head: the int schedule, a float
    schedule, and the int schedule with [B, C, P] sampled thresholds."""
    p = thr.shape[0]
    samples = torch.rand((b, n_cls, p), generator=gen, device=dev) \
        * (2 * float(thr.max()))
    return (("int", thr, None), ("float", thr.float() + 0.5, None),
            ("sampled", thr, samples))


def conv_work(pipe, b: int, p: int, stage: bool, kw_q: int = 0):
    """The work of kernel 4's function (stage=True: its conv stack and
    flatten only, writing kw_q words per query) on a batch of b, as
    `Card.bound_ms` takes it: (popcounts, ALU operations, bytes, bit
    products, ALU operations beside the products).

    A conv output needs ceil(k*k*c_in/32) popcounts on the popcount route
    (each position's k*k pixels first packed densely, a shift and an OR
    per pixel word, shared by the position's c_out channels), and
    k*k*c_in bit products on a tensor-core route.  Either way a conv or
    FC output costs 2 ALU operations, a compare of its distance against
    the channel's fixed limit (y = n_bits - 2*HD + C >= 0 is
    HD <= (n_bits + C) >> 1) and the repack, and the head's vote 2 a
    threshold."""
    conv = pipe.conv
    popc = alu = macs = alu_tc = 0
    nbytes = 4 * b * conv.side ** 2 * conv.metas[0].cw_in
    for m, w in zip(conv.metas, conv.ws):
        n_pos, padded = m.out_side ** 2, m.k * m.k * m.cw_in
        dense = -(-m.n_bits // 32)
        popc += n_pos * m.c_out * dense
        alu += 2 * n_pos * m.c_out + (2 * n_pos * padded if dense < padded
                                      else 0)
        macs += n_pos * m.c_out * m.n_bits
        alu_tc += 2 * n_pos * m.c_out
        nbytes += 4 * (w.numel() + m.c_out)
    if stage:
        nbytes += 4 * b * kw_q
        return b * popc, b * (2 * popc + alu), nbytes, b * macs, b * alu_tc
    t = tail_work(pipe, b, p)
    return (b * popc + t[0], b * (2 * popc + alu) + t[1], nbytes + t[2],
            b * macs + t[3], b * alu_tc + t[4])


def tail_work(pipe, b: int, p: int):
    """The work of kernel 3's function, the FC layers and the head's vote
    (kernel 4's tail), on b packed queries, as `conv_work` gives it,
    the queries' own bytes left out: an FC output and a head distance
    cost a popcount a word (their bits on a tensor-core route), and 2
    ALU operations (`conv_work`), a threshold 2 a vote."""
    popc = alu = macs = alu_tc = nbytes = 0
    head = pipe.head.cam.rows_packed
    for w, n in zip(pipe.layer_ws, pipe.layer_n_bits):
        popc += w.numel()
        alu += 2 * w.shape[0]
        macs += w.shape[0] * n
        alu_tc += 2 * w.shape[0]
        nbytes += 4 * (w.numel() + w.shape[0])
    popc += head.numel()
    alu += 2 * head.shape[0] * p
    macs += head.shape[0] * pipe.head.cam.n_bits
    alu_tc += 2 * head.shape[0] * p
    nbytes += 4 * (head.numel() + p + b * head.shape[0])
    return (b * popc, b * (2 * popc + alu), nbytes, b * macs, b * alu_tc)


def gemm_row(card, x, w, ms, call_ms, plain_ms, lib_ms, err) -> dict:
    """A kernels-line row of kernel 1 on x [M, Kw] against w [N, Kw]."""
    (m, kw), n = x.shape, w.shape[0]
    pairs = m * n * kw
    return dict(shape=f"x[{m},{kw}] w[{n},{kw}]", ms=ms, call_ms=call_ms,
                plain_ms=plain_ms, **bound_fields(
                    card, pairs, 2 * pairs, 4 * (m * kw + n * kw + m * n),
                    32 * pairs, 0),
                library_ms=lib_ms, max_abs_err=err)


def check_gemm_at_cnn(pipe, q, card, mid: str, report: dict) -> None:
    """Kernel 1 at the shapes a CNN's cumulative staircase gives it: the
    flattened conv query q against the FC rows (timed and bounded beside
    `torch._int_mm` on the unpacked ±1 operands), then the head query
    against the head rows, each `torch.equal` to the plain version."""
    from repro_torch.core import binarize
    from repro_torch.kernels import binary_gemm

    require(len(pipe.layer_ws) == 1, f"{mid}: expected one FC layer")
    w, head = pipe.layer_ws[0], pipe.head.cam.rows_packed
    hd = binary_gemm.binary_gemm_hd(q, w)
    want = binary_gemm.binary_gemm_hd_plain(q, w)
    require(torch.equal(hd, want), f"{mid}: binary_gemm_hd (FC) != plain")
    # the head query as pipeline.head_hd builds it: signs + bias drive bits
    bits = ((pipe.layer_n_bits[0] - 2 * hd) + pipe.layer_cs[0][None, :]
            >= 0).to(torch.uint8)
    ones = torch.ones((bits.shape[0], pipe.head.bias_cells),
                      dtype=torch.uint8, device=q.device)
    qh = binarize.pack_bits(torch.cat([bits, ones], dim=-1))
    qh = torch.nn.functional.pad(qh, (0, head.shape[1] - qh.shape[1]))
    require(torch.equal(binary_gemm.binary_gemm_hd(qh, head),
                        binary_gemm.binary_gemm_hd_plain(qh, head)),
            f"{mid}: binary_gemm_hd (head) != plain")
    # the library yardstick: n - 2*HD from int8 tensor cores
    kw = q.shape[1]
    x_i8 = binarize.unpack_bits(q, 32 * kw).to(torch.int8) * 2 - 1
    w_i8 = binarize.unpack_bits(w, 32 * kw).to(torch.int8) * 2 - 1
    require(torch.equal(torch._int_mm(x_i8, w_i8.t()), 32 * kw - 2 * hd),
            f"{mid}: torch._int_mm != n - 2*binary_gemm_hd")
    report["binary_gemm_hd"]["per_model"][mid] = row = gemm_row(
        card, q, w, device_ms(lambda: binary_gemm.binary_gemm_hd(q, w)),
        time_ms(lambda: binary_gemm.binary_gemm_hd(q, w), 100),
        time_ms(lambda: binary_gemm.binary_gemm_hd_plain(q, w), 3),
        device_ms(lambda: torch._int_mm(x_i8, w_i8.t())),
        int((hd - want).abs().max()))
    print(f"  {mid:9s} binary_gemm_hd == plain (FC, head) {row['shape']}: "
          f"kernel {row['ms']} ms (call {row['call_ms']:.4f} ms), plain "
          f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_route']}), library {row['library_ms']}")


def check_conv_kernels(pipe, xp, gen, card, mid: str, report: dict,
                       timed: bool) -> None:
    """Kernel 4 and its stage entry against their plain versions on the
    card (all three threshold forms); with `timed`, their device, call
    and plain times and bounds go into `report`."""
    from repro_torch.kernels import fused_conv

    conv, head = pipe.conv, pipe.head
    b, dev = xp.shape[0], xp.device
    args = (xp, conv.ws, conv.cs, conv.metas, pipe.layer_ws, pipe.layer_cs,
            pipe.layer_n_bits, head.cam.rows_packed)
    kw = dict(bias_cells=head.bias_cells, head_direct=conv.head_direct)
    errs = []
    for form, t, s in threshold_forms(head.thresholds, b, head.n_classes,
                                      gen, dev):
        got = fused_conv.fused_conv_votes(*args, t, thr_samples=s, **kw)
        want = fused_conv.fused_conv_votes_plain(*args, t, thr_samples=s,
                                                 **kw)
        require(torch.equal(got, want),
                f"{mid}: fused_conv_votes[{form}] != plain")
        errs.append(int((got - want).abs().max()))
    # the stage entry as the cumulative staircase calls it: zero words up
    # to the first FC/head operand's width
    bias = head.bias_cells if conv.head_direct else 0
    kw_q = (pipe.layer_ws[0] if pipe.layer_ws
            else head.cam.rows_packed).shape[1]
    sargs = (xp, conv.ws, conv.cs, conv.metas)
    bw = fused_conv.bias_drive_words(bias) if bias else None
    got = fused_conv.conv_stage_packed(*sargs, bias_cells=bias, kw_q=kw_q)
    want = fused_conv.conv_stage_packed_plain(*sargs, bw, kw_q)
    require(torch.equal(got, want), f"{mid}: conv_stage_packed != plain")
    stage_err = int((got - want).abs().max()) if got.numel() else 0
    print(f"  {mid:9s} fused_conv_votes == plain (int, float, sampled), "
          f"conv_stage_packed == plain, B={b}")
    if not timed:
        return
    check_gemm_at_cnn(pipe, got, card, mid, report)
    thr = head.thresholds
    maps = conv.side, conv.metas[0].cw_in
    for name, fn, plain, stage, err in (
            ("fused_conv_votes",
             lambda: fused_conv.fused_conv_votes(*args, thr, **kw),
             lambda: fused_conv.fused_conv_votes_plain(*args, thr, **kw),
             False, max(errs)),
            ("conv_stage_packed",
             lambda: fused_conv.conv_stage_packed(*sargs, bias_cells=bias,
                                                  kw_q=kw_q),
             lambda: fused_conv.conv_stage_packed_plain(*sargs, bw, kw_q),
             True, stage_err)):
        report[name]["per_model"][mid] = dict(
            shape=f"x[{b},{maps[0]},{maps[0]},{maps[1]}] conv "
                  f"{[(m.k, m.c_out, m.stride) for m in conv.metas]} "
                  f"fc {[w.shape[0] for w in pipe.layer_ws]} "
                  f"C={head.n_classes} P={thr.shape[0]}",
            ms=device_ms(fn, iters=20), call_ms=time_ms(fn, 20),
            plain_ms=time_ms(plain, 3),
            **bound_fields(card, *conv_work(pipe, b, thr.shape[0], stage,
                                            kw_q)),
            library_ms=None, max_abs_err=err)


def sampled_form_rows(pipe, x, gen, card, mid: str, report: dict) -> None:
    """Kernel 3 (MLP) or 4 (CNN) in its sampled-threshold form, fed by
    the port's sampler, at the largest batch: device, call and plain
    times and the bound, into `report[...]["sampled"][mid]`.  The
    sampler itself is timed beside it (`sampler_ms`)."""
    from repro_torch.kernels import fused_conv, fused_mlp

    head, phys = pipe.head, pipe.physics
    xp = pipe._pack_input(torch.as_tensor(x).to(pipe.device))
    b, n_cls, p = xp.shape[0], head.n_classes, head.thresholds.shape[0]
    samples = phys.sample(gen, (b,), n_cls).movedim(0, -1).contiguous()
    if pipe.conv is not None:
        conv = pipe.conv
        args = (conv.maps(xp), conv.ws, conv.cs, conv.metas, pipe.layer_ws,
                pipe.layer_cs, pipe.layer_n_bits, head.cam.rows_packed,
                head.thresholds)
        kw = dict(bias_cells=head.bias_cells, head_direct=conv.head_direct,
                  thr_samples=samples)
        name, fn, plain = ("fused_conv_votes", fused_conv.fused_conv_votes,
                           fused_conv.fused_conv_votes_plain)
        work = list(conv_work(pipe, b, p, False))
    else:
        args = (xp, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits,
                head.cam.rows_packed, head.thresholds)
        kw = dict(bias_cells=head.bias_cells, thr_samples=samples)
        name, fn, plain = ("fused_mlp_votes", fused_mlp.fused_mlp_votes,
                           fused_mlp.fused_mlp_votes_plain)
        work = list(tail_work(pipe, b, p))
        work[2] += 4 * xp.numel()
    work[2] += 4 * samples.numel()  # the [B, C, P] operand, read once
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    require(torch.equal(got, want), f"{mid}: {name}[sampled, sampler] != "
            "plain")
    report[name].setdefault("sampled", {})[mid] = row = dict(
        shape=f"x[{b}] thr_samples[{b},{n_cls},{p}]",
        ms=device_ms(lambda: fn(*args, **kw), iters=20),
        call_ms=time_ms(lambda: fn(*args, **kw), 20),
        plain_ms=time_ms(lambda: plain(*args, **kw), 3),
        **bound_fields(card, *work),
        max_abs_err=int((got - want).abs().max()))
    print(f"  {mid:9s} {name}[sampled] {row['shape']}: kernel {row['ms']} "
          f"ms (call {row['call_ms']:.4f} ms), plain {row['plain_ms']:.3f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_route']})")


def keyed_sampler_rows(pipe, card: "Card", batches, seed: int) -> dict:
    """The keyed sampler's kernel (`keyed_thresholds`) against its plain
    version at `pipe`'s head (P passes, one row a class, one sample):
    `torch.equal` required, then device ms a launch (CUDA-graph replay),
    call ms and the plain version's device ms, beside the bound: the
    larger of the Threefry ALU operations, the float64 operations (each at
    64 lanes a clock an SM) and the output's bytes."""
    from repro_torch.core.keys import as_key_words
    from repro_torch.kernels import keyed_sampler as ks

    ph, n = pipe.physics, pipe.n_classes
    fields = (ph.thresholds, ph.m_logical, ph.dm_dvref)
    rows = {}
    for b in batches:
        k = np.random.default_rng(seed + b).integers(
            0, 2 ** 32, (b, 2), dtype=np.uint64).astype(np.uint32)
        kw = as_key_words(k, pipe.device)

        def kernel():
            return ks.keyed_thresholds(kw, *fields, ph.noise, n)

        def plain():
            return ks.keyed_thresholds_plain(kw, *fields, ph.noise, n)

        require(torch.equal(kernel(), plain()),
                f"keyed sampler B={b}: kernel != plain")
        normals = ph.n_passes * b * (n + 2)
        clk = card.sms * card.clock_hz
        bound = {"alu": normals * THREEFRY_ALU_OPS / ALU_PER_CLK_SM / clk,
                 "fp64": normals * BOX_MULLER_FP64_OPS / FP64_PER_CLK_SM
                 / clk,
                 "bytes": (ph.n_passes * b * n * 4 + b * 16)
                 / MEM_BYTES_PER_S}
        by = max(bound, key=bound.get)
        rows[f"[{ph.n_passes},1,{b},{n}]"] = row = dict(
            ms=device_ms(kernel, iters=20, replays=5),
            call_ms=time_ms(kernel, 20),
            plain_ms=device_ms(plain, iters=2, replays=2),
            bound_ms=bound[by] * 1e3, bound_by=by,
            bound_routes={k: v * 1e3 for k, v in bound.items()})
        print(f"  keyed sampler [{ph.n_passes},1,{b},{n}]: kernel "
              f"{row['ms']} ms (call {row['call_ms']:.4f} ms), plain "
              f"{row['plain_ms']} ms, bound {row['bound_ms']:.4f} ms "
              f"({by})")
    return rows


def sampler_ms(pipe, b: int) -> dict:
    """Device time of the batch sampler (`SearchPhysics.sample` [P, B, C]
    and the move to the kernel's [B, C, P] layout) at batch b: CUDA-graph
    replay on the card's default generator, which a graph captures with
    its state; a custom generator is not captured, so the pipeline's own
    calls are timed by `run()` only.  Bound: the [P, B, C] float32
    samples written once and moved once (read and written)."""
    phys, n_cls = pipe.physics, pipe.n_classes
    on_card = pipe.device.type == "cuda"
    gen = (torch.cuda.default_generators[pipe.device.index or 0] if on_card
           else torch.Generator().manual_seed(0))

    def draw():
        return phys.sample(gen, (b,), n_cls).movedim(0, -1).contiguous()

    n = phys.n_passes * b * n_cls * 4
    return dict(shape=f"[{phys.n_passes},{b},{n_cls}]",
                ms=device_ms(draw, iters=20), call_ms=time_ms(draw, 20),
                bound_ms=3 * n / MEM_BYTES_PER_S * 1e3, bound_by="bytes",
                timing="CUDA-graph replay, default CUDA generator")


def silicon_phase(dev, b_main: int, batches, card, smi: str, models: dict,
                  cnns: dict, report: dict, counted) -> dict:
    """Phase 5: silicon mode on the main path.

    The two MLPs and two CNNs compiled with noise=SILICON (no device
    argument on the card), run at every batch size for noise="batch"
    votes and argmax (kernels 3 / 4 with sampled thresholds) and
    per-request votes and MC-8 sums (head distances once: kernel 1,
    after the stage entry for a CNN), noisy cumulative at B = 100, an HG
    MLP with a calibrated (float) head, NOISELESS pipelines on every
    noisy spec, and one server with a silicon MLP and a silicon CNN
    answering keyed requests.  Every launch count is set to 0 just
    before and read just after; then the checks, then the times.
    Returns {"launches": ..., "e2e": ..., "sampler": ...}."""
    from repro_torch.configs.paper_cnn import build_cnn_pipeline
    from repro_torch.core.device_model import NOISELESS, SILICON
    from repro_torch.core.ensemble import EnsembleConfig
    from repro_torch.kernels.keyed_sampler import keyed_thresholds
    from repro_torch.pipeline import compile_pipeline, next_bucket
    from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
    from repro_torch.spec import InferenceSpec

    on_card = dev.type == "cuda"
    here = {} if on_card else {"device": dev}
    t0 = time.perf_counter()
    every = {**models, **cnns}

    def make(m, noise, **kw):
        if hasattr(m["cfg"], "side"):  # a CNN config
            return build_cnn_pipeline(m["cfg"], m["folded"], noise=noise,
                                      **kw)
        return compile_pipeline(m["folded"], EnsembleConfig(
            bias_cells=m["cfg"].bias_cells), noise=noise, **kw)

    for mid, m in every.items():
        m["si_gpu"] = make(m, SILICON, **here)
        m["si_cpu"] = make(m, SILICON, device="cpu")
        m["nl_gpu"] = make(m, NOISELESS, **here)
        require(m["si_gpu"].device == dev and not
                m["si_gpu"].physics.is_noiseless,
                f"{mid}: compile_pipeline(noise=SILICON) not a silicon "
                "pipeline on the card")
    cal = EnsembleConfig(calibrated=True)
    hg = models["hg"]
    cal_gpu = compile_pipeline(hg["folded"], cal, **here)
    cal_cpu = compile_pipeline(hg["folded"], cal, device="cpu")
    require(cal_gpu.head.thresholds.dtype == torch.float32,
            "calibrated head thresholds are not float32")
    print(f"silicon: compiled {len(every)} x (SILICON card, SILICON CPU, "
          f"NOISELESS card) + calibrated HG in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 11)
    keys = rng.integers(0, 2 ** 32, (b_main, 2), dtype=np.uint64).astype(
        np.uint32)
    batch = InferenceSpec(noise="batch")
    specs = {"batch": batch,
             "batch_argmax": InferenceSpec(noise="batch",
                                           reduction="argmax"),
             "per_request": InferenceSpec(noise="per_request"),
             "per_request_mc8_sum": InferenceSpec(
                 noise="per_request", mc_samples=8, reduction="sum")}
    cum = InferenceSpec(noise="batch", cumulative=True)
    gen = torch.Generator(dev).manual_seed(SEED + 12)

    # --------------------------------- the silicon path, counts from 0
    for fn in (*counted, keyed_thresholds):
        fn.launches = 0
    out, states = {}, {}
    for mid, m in every.items():
        for bsz in batches:
            for sname, spec in specs.items():
                if spec.needs_key:
                    states[(mid, bsz, sname)] = gen.get_state()
                out[(mid, bsz, sname)] = m["si_gpu"].run(
                    m["x"][:bsz], spec, key=gen if spec.needs_key else None,
                    keys=keys[:bsz] if spec.needs_keys else None)
        states[(mid, 100, "cumulative")] = gen.get_state()
        out[(mid, 100, "cumulative")] = m["si_gpu"].run(m["x"][:100], cum,
                                                        key=gen)
        for sname, spec in {**specs, "cumulative": cum}.items():
            out[(mid, 100, "noiseless/" + sname)] = m["nl_gpu"].run(
                m["x"][:100], spec, key=gen if spec.needs_key else None,
                keys=keys[:100] if spec.needs_keys else None)
    for bsz in batches:
        out[("hg_cal", bsz, "votes")] = cal_gpu.run(hg["x"][:bsz],
                                                    InferenceSpec())
    server = PicBnnServer(BatchingPolicy(max_batch=256, max_wait_us=500),
                          devices=None if on_card else [dev])
    served_ids = {"si_mlp": "hg", "si_cnn": "mnist_cnn"}
    for sid, mid in served_ids.items():
        server.register(sid, every[mid]["si_gpu"])
    server.warmup()
    served = {}
    with server:
        singles = {sid: [server.submit(sid, every[mid]["x"][i], key=keys[i])
                         for i in range(100)]
                   for sid, mid in served_ids.items()}
        bursts = {sid: server.submit_many(sid, every[mid]["x"][100:400],
                                          keys=keys[100:400])
                  for sid, mid in served_ids.items()}
        for sid in served_ids:
            served[sid] = np.concatenate(
                [np.stack([h.result(timeout=120).votes
                           for h in singles[sid]]),
                 bursts[sid].votes_all(timeout=120)])
    if on_card:
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches
                for fn in (*counted, keyed_thresholds)}
    print(f"silicon path: launches {launches}")
    for fn in (*counted, keyed_thresholds):
        if fn.__name__ != "cam_vote":
            require(launches[fn.__name__] > 0 or not on_card,
                    f"{fn.__name__} was not launched on the silicon path")
    n_req = sum(len(every[mid]["x"][:400]) for mid in served_ids.values())
    require(server.stats().n_requests == n_req,
            "silicon server did not answer every request")

    # ------------------------------------------------------------ checks
    agree = {}
    for mid, m in every.items():
        gpu, cpu = m["si_gpu"], m["si_cpu"]
        for bsz in batches:
            bp = next_bucket(bsz, gpu.min_bucket)
            xg, _ = gpu._bucketed(gpu._pack_input(
                torch.from_numpy(m["x"][:bsz]).to(dev)))
            hd_dev = gpu._head_distances(xg).float()
            # CPU distances, except the CNNs at the largest batch (their
            # plain conv on the CPU would dominate the run): there the
            # card's own HD-once route (stage + kernel 1)
            cnn_big = mid in cnns and bsz > 100
            if not cnn_big:
                xc, _ = cpu._bucketed(cpu._pack_input(
                    torch.from_numpy(m["x"][:bsz])))
                hd_cpu = cpu._head_distances(xc).float()
                require(torch.equal(hd_dev.cpu(), hd_cpu),
                        f"{mid} B={bsz}: card head distances != CPU")
            for sname in ("batch", "batch_argmax"):
                replay = torch.Generator(dev)
                replay.set_state(states[(mid, bsz, sname)])
                s = gpu.physics.sample(replay, (bp,), gpu.n_classes)
                if cnn_big:
                    votes = (hd_dev <= s).sum(0, dtype=torch.int32)[:bsz]
                else:
                    votes = (hd_cpu <= s.cpu()).sum(0, dtype=torch.int32)[
                        :bsz]
                if sname == "batch_argmax":
                    votes = torch.argmax(votes, dim=-1).to(torch.int32)
                got = out[(mid, bsz, sname)]
                require(got.device == dev and torch.equal(
                    got.cpu(), votes.cpu()),
                    f"{mid} B={bsz} {sname}: card votes != the CPU compare "
                    "of the replayed samples")
            kw = gpu._each_keys(keys[:bsz], bsz, bp)
            for sname, mc in (("per_request", 1),
                              ("per_request_mc8_sum", 8)):
                t = gpu.physics.sample_keyed(kw, gpu.n_classes, mc)
                own = (hd_dev <= t).sum(0, dtype=torch.int32).sum(
                    0, dtype=torch.int32)[:bsz]
                require(torch.equal(out[(mid, bsz, sname)], own),
                        f"{mid} B={bsz} {sname}: card votes != its own "
                        "compare of its keyed samples")
            if not cnn_big:
                want = cpu.run(m["x"][:bsz], specs["per_request"],
                               keys=keys[:bsz])
                agree[f"{mid}/B={bsz}"] = float(
                    (out[(mid, bsz, "per_request")].cpu() == want)
                    .to(torch.float32).mean())
        replay = torch.Generator(dev)
        replay.set_state(states[(mid, 100, "cumulative")])
        xc, _ = cpu._bucketed(cpu._pack_input(torch.from_numpy(
            m["x"][:100])))
        s = gpu.physics.sample(replay, (next_bucket(100, gpu.min_bucket),),
                               gpu.n_classes).cpu()
        stair = torch.cumsum(cpu._head_distances(xc).float() <= s, 0,
                             dtype=torch.int32)[:, :100]
        require(torch.equal(out[(mid, 100, "cumulative")].cpu(), stair),
                f"{mid}: noisy cumulative != the replayed staircase")
        base = m["gpu"].run(m["x"][:100], InferenceSpec())
        for sname, spec in {**specs, "cumulative": cum}.items():
            got = out[(mid, 100, "noiseless/" + sname)]
            want = (base.argmax(-1).to(torch.int32) if "argmax" in sname
                    else 8 * base if "mc8" in sname
                    else m["gpu"].run(m["x"][:100],
                                      InferenceSpec(cumulative=True))
                    if sname == "cumulative" else base)
            require(torch.equal(got, want),
                    f"{mid}: NOISELESS {sname} != the noiseless votes")
    for bsz in batches:
        require(torch.equal(out[("hg_cal", bsz, "votes")].cpu(),
                            cal_cpu.run(hg["x"][:bsz], InferenceSpec())),
                f"calibrated HG B={bsz}: card != CPU")
    for sid, mid in served_ids.items():
        direct = every[mid]["si_gpu"].run(
            every[mid]["x"][:400], specs["per_request"], keys=keys[:400])
        require(np.array_equal(served[sid], direct.cpu().numpy()),
                f"{sid}: served silicon votes != direct run")
    print(f"  silicon: batch votes/argmax == CPU compare of the replayed "
          f"samples, per-request == own compare, NOISELESS == noiseless, "
          f"calibrated == CPU, served == direct ({n_req} keyed requests)")
    print(f"  per-request card vs CPU agreement: {agree}")

    # ------------------------------------------------------------- times
    sampled = {}
    for mid, m in every.items():
        sampled_form_rows(m["si_gpu"], m["x"], gen, card, mid, report)
    e2e = {}
    xs = {mid: torch.from_numpy(m["x"]).to(dev) for mid, m in every.items()}
    for mid, m in every.items():
        for sname, spec in specs.items():
            ms = time_ms(lambda: m["si_gpu"].run(
                xs[mid], spec, key=gen if spec.needs_key else None,
                keys=keys if spec.needs_keys else None), 5)
            e2e[f"{mid}/B={b_main}/{sname}"] = dict(
                ms=ms, inf_per_s=b_main / ms * 1e3)
            print(f"  run {mid:9s} B={b_main} {sname:20s}: {ms:.4f} ms")
        sampled[mid] = sampler_ms(m["si_gpu"], b_main)
        print(f"  sampler {mid:9s} {sampled[mid]['shape']}: device "
              f"{sampled[mid]['ms']} ms (call {sampled[mid]['call_ms']:.4f} "
              f"ms), bound {sampled[mid]['bound_ms']:.4f} ms")
    # the keyed (per-request) sampler alone, and where a per-request
    # run() goes: device kernels against the rest of the call
    keyed = {}
    for mid in ("mnist", "hg"):
        pipe = every[mid]["si_gpu"]
        kw = pipe._each_keys(keys, b_main, b_main)
        for mc in (1, 8):
            draw = (lambda: pipe.physics.sample_keyed(kw, pipe.n_classes,
                                                      mc))
            keyed[f"{mid}/B={b_main}/mc={mc}"] = row = dict(
                ms=device_ms(draw, iters=5, replays=3),
                call_ms=time_ms(draw, 5))
            print(f"  keyed sampler {mid:5s} mc={mc}: device {row['ms']} ms "
                  f"(call {row['call_ms']:.4f} ms)")
    # the kernel alone at the benchmark's silicon cells' shape
    keyed_kernel = keyed_sampler_rows(
        every["hg"]["si_gpu"], card,
        (32768, b_main) if on_card else (b_main,), SEED + 13)
    split = profile_split(lambda: every["hg"]["si_gpu"].run(
        xs["hg"], specs["per_request"], keys=keys), 5)
    print(f"  profile hg B={b_main} run() per_request: "
          f"{split['call_ms']:.4f} ms a call, device kernels "
          f"{split['device_kernel_ms']:.4f} ms in "
          f"{len(split['kernels'])} kernel names")
    split["kernels"] = dict(list(split["kernels"].items())[:8])
    return dict(launches=launches, e2e=e2e, sampler=sampled,
                keyed_sampler=keyed, keyed_kernel=keyed_kernel,
                agreement=agree,
                profile={f"hg/B={b_main}/per_request": split}, card=smi)


# card vs CPU on the same params and batch: float32 sums in another order
# (cuDNN's TF32 off for the comparison; the ±1 forward products are exact)
GRAD_TOL = 1e-5
# phase 6's synthetic data (train, test) and epochs: the quickstart's
# MLP recipe, a few epochs for the CNNs
TRAIN_DATA = (8000, 1000)
TRAIN_EPOCHS = {"mlp": 10, "cnn": 3}
TRAIN_LR = 2e-3
TRAIN_BATCH = 128


def train_phase(dev, smi: str, counted, quick: bool) -> dict:
    """Phase 6: train the paper's MLPs and CNNs on `dev` from synthetic
    data, deploy them through kernels 3 and 4, map the MNIST MLP onto
    the CAM banks, check the int8 product, print Table II and serve the
    trained models with their silicon-equivalent rates.  `quick` cuts
    the data and epochs for a CPU rehearsal."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.paper_cnn import HG_CNN, MNIST_CNN, deploy_cnn
    from repro_torch.configs.paper_mlp import (HG_MLP, MNIST_MLP,
                                               PAPER_ENSEMBLE, deploy_mlp)
    from repro_torch.core import bnn, convnet, ensemble, mapping
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
    from repro_torch.spec import PREDICT, VOTES

    on_card = dev.type == "cuda"
    n_train, n_test = (1024, 320) if quick else TRAIN_DATA
    t_data = t_phase = time.perf_counter()
    data = {}
    for name, spec in (("mnist", synthetic.MNIST_LIKE),
                       ("hg", synthetic.HG_LIKE)):
        tx, ty, vx, vy = synthetic.make_dataset(spec, n_train, n_test,
                                                seed=SEED)
        data[name] = dict(tx=tx, ty=ty, vx=vx, vy=vy,
                          txb=synthetic.binarize_images(tx),
                          vxb=synthetic.binarize_images(vx))
    print(f"train: synthetic data {n_train} + {n_test} a task in "
          f"{time.perf_counter() - t_data:.1f} s")
    # (id, data, config, kind): the MLPs take ±1 images, the CNNs pixels
    models = [("mnist_mlp", "mnist", MNIST_MLP, "mlp"),
              ("hg_mlp", "hg", HG_MLP, "mlp"),
              ("mnist_cnn", "mnist", MNIST_CNN, "cnn"),
              ("hg_cnn", "hg", HG_CNN, "cnn")]

    def inputs(mid, kind, split):
        d = data[mid.split("_")[0]]
        return d[f"{split}xb"] if kind == "mlp" else d[f"{split}x"]

    # ---- one gradient step on the card against the CPU (full widths)
    grad = {}
    for mid, _, cfg, kind in models:
        loss = bnn.loss_fn if kind == "mlp" else convnet.cnn_loss
        init = bnn.init_params if kind == "mlp" else convnet.init_cnn_params
        params = init(torch.Generator().manual_seed(SEED), cfg)
        x = inputs(mid, kind, "t")[:TRAIN_BATCH]
        y = data[mid.split("_")[0]]["ty"][:TRAIN_BATCH]
        out = []
        for d in (dev, torch.device("cpu")):
            p = {g: [{k: v.to(d).requires_grad_(k in bnn.TRAINED)
                      for k, v in layer.items()} for layer in ls]
                 for g, ls in params.items()}
            leaves = [layer[k] for ls in p.values() for layer in ls
                      for k in bnn.TRAINED]
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                value, new = loss(p, x, y, cfg)
                grads = torch.autograd.grad(value, leaves)
            out.append([value.detach().reshape(1)] + list(grads)
                       + [layer[k] for ls in new.values() for layer in ls
                          for k in ("mean", "var")])
        err = 0.0
        for a, b in zip(*out):
            a, b = a.detach().cpu(), b.detach().cpu()
            e = (a - b).abs()
            require(bool((e <= GRAD_TOL + 1e-5 * b.abs()).all()),
                    f"{mid}: gradient step card != CPU (max {e.max()})")
            err = max(err, float(e.max()))
        grad[mid] = dict(max_abs_err=err, tol=f"{GRAD_TOL} + 1e-5*|cpu|",
                         leaves=len(out[0]))
        print(f"  grad {mid:9s}: card vs CPU max |err| {err:.3g} over "
              f"{len(out[0])} tensors (tol {GRAD_TOL} + 1e-5*|cpu|)")

    # ---- the path: train, checkpoint, deploy, run, serve
    for fn in counted:
        fn.launches = 0
    results, deps = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt") as root:
        for mid, dname, cfg, kind in models:
            d = data[dname]
            epochs = 1 if quick else TRAIN_EPOCHS[kind]
            ck = ckpt.AsyncCheckpointer(Path(root) / mid, keep_last=2)
            train = bnn.train_mlp if kind == "mlp" else convnet.train_cnn
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = train(torch.Generator().manual_seed(SEED), cfg,
                           inputs(mid, kind, "t"), d["ty"], epochs=epochs,
                           batch=TRAIN_BATCH, lr=TRAIN_LR,
                           on_epoch=lambda p, e: ck.save_async(e, p),
                           **({} if on_card else {"device": dev}))
            if on_card:
                torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            steps = epochs * max(n_train // TRAIN_BATCH, 1)
            ck.wait()
            back, step = ckpt.restore(Path(root) / mid, None, params,
                                      device=dev)
            require(step == epochs - 1 and all(
                torch.equal(a, b) for g in params
                for la, lb in zip(params[g], back[g])
                for a, b in ((la[k], lb[k]) for k in la)),
                f"{mid}: restored checkpoint != the live params")
            require(params[next(iter(params))][0]["w"].device == dev,
                    f"{mid}: trained params not on {dev}")
            acc = (bnn.eval_accuracy if kind == "mlp"
                   else convnet.eval_cnn_accuracy)
            sw = acc(params, cfg, inputs(mid, kind, "v"), d["vy"])["top1"]
            # no device argument: the Deployment compiles on the card
            dep = (deploy_mlp if kind == "mlp" else deploy_cnn)(
                cfg, params, **({} if on_card else {"device": dev}))
            deps[mid] = dep
            x = inputs(mid, kind, "v")
            votes = dep.run(x, VOTES)
            pred = dep.run(x, PREDICT)
            require(votes.device == dev and pred.device == dev,
                    f"{mid}: deployed run() left {dev}")
            e2e = float((pred.cpu().numpy() == d["vy"]).mean())
            results[mid] = dict(
                params=params, x=x, votes=votes, pred=pred, cfg=cfg,
                kind=kind, row=dict(
                    epochs=epochs, steps=steps, train_s=train_s,
                    ms_per_step=train_s * 1e3 / steps,
                    steps_per_s=steps / train_s, sw_top1=sw, e2e_top1=e2e,
                    checkpoint="restored == live", card=smi))
            print(f"  train {mid:9s}: {steps} steps in {train_s:.2f} s -> "
                  f"{train_s * 1e3 / steps:.3f} ms/step, "
                  f"{steps / train_s:.1f} steps/s; top-1 software {sw:.4f}, "
                  f"end-to-end binary {e2e:.4f} [{smi}]")
    policy = BatchingPolicy(max_batch=256, max_wait_us=500)
    server = PicBnnServer(policy, devices=None if on_card else [dev])
    for mid, dep in deps.items():
        kw = ({} if results[mid]["kind"] == "mlp" else  # MLPs: derived
              {"silicon_cost": convnet.cnn_inference_cost(
                  results[mid]["cfg"])})
        server.register(mid, dep, **kw)
    server.warmup()
    n_req = 300
    with server:
        singles = {mid: [server.submit(mid, r["x"][i]) for i in range(100)]
                   for mid, r in results.items()}
        bursts = {mid: server.submit_many(mid, r["x"][100:n_req])
                  for mid, r in results.items()}
        served = {mid: np.concatenate(
            [np.stack([h.result(timeout=60).votes for h in singles[mid]]),
             bursts[mid].votes_all(timeout=60)]) for mid in results}
    if on_card:
        torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"train path: launches {launches}")
    for name in ("fused_mlp_votes", "fused_conv_votes"):
        require(launches[name] > 0 or not on_card,
                f"{name} was not launched on the train path")
    stats = server.stats()
    print(stats.summary())

    # where a training step goes: one torch.profiler pass over epochs of
    # ten steps (device kernels against the rest of the call)
    steps_split = {}
    for mid, dname, cfg, kind in models:
        train = bnn.train_mlp if kind == "mlp" else convnet.train_cnn
        n10 = 10 * TRAIN_BATCH
        x10 = inputs(mid, kind, "t")[:n10]
        y10 = data[dname]["ty"][:n10]
        split = profile_split(lambda: train(
            torch.Generator().manual_seed(SEED), cfg, x10, y10, epochs=1,
            batch=TRAIN_BATCH, lr=TRAIN_LR,
            **({} if on_card else {"device": dev})), 3)
        steps_split[mid] = dict(
            step_ms=split["call_ms"] / 10,
            device_kernel_ms_per_step=split["device_kernel_ms"] / 10,
            device_share=split["device_share"],
            kernel_names=len(split["kernels"]))
        print(f"  profile train {mid:9s}: {split['call_ms'] / 10:.3f} ms a "
              f"step (ten-step epochs, init included), device kernels "
              f"{split['device_kernel_ms'] / 10:.4f} ms in "
              f"{len(split['kernels'])} kernel names")

    # ---- what came out: card == CPU, the accuracy band, served == direct
    for mid, r in results.items():
        cpu = deps[mid].pipeline("cpu")
        want = cpu.run(r["x"], VOTES)
        require(torch.equal(r["votes"].cpu(), want),
                f"{mid}: trained votes on the card != CPU pipeline")
        require(torch.equal(r["pred"].cpu().long(), want.argmax(-1)),
                f"{mid}: PREDICT on the card != argmax of the CPU votes")
        row = r["row"]
        require(row["e2e_top1"] >= row["sw_top1"] - 0.05,
                f"{mid}: end-to-end binary top-1 {row['e2e_top1']:.4f} < "
                f"software {row['sw_top1']:.4f} - 0.05")
        direct = r["votes"][:n_req].cpu().numpy()
        require(np.array_equal(served[mid], direct),
                f"{mid}: served votes != direct run")
        ms = stats.per_model[mid]
        require(ms.silicon_inf_per_s is not None and ms.vs_silicon,
                f"{mid}: no silicon-equivalent rate in the server's stats")
        row.update(votes_equal_cpu=True, served_inf_per_s=ms.inf_per_s,
                   silicon_inf_per_s=ms.silicon_inf_per_s,
                   vs_silicon=ms.vs_silicon)
        print(f"  {mid:9s}: card == CPU votes on {len(r['x'])} test images, "
              f"served {ms.inf_per_s:,.0f} inf/s = x{ms.vs_silicon:.3f} of "
              f"the macro's modelled {ms.silicon_inf_per_s:,.0f} inf/s")

    # ---- the MNIST MLP's hidden layer through the CAM tiles
    r = results["mnist_mlp"]
    folded = deps["mnist_mlp"].folded
    mapped = mapping.map_layer(folded[0], MNIST_MLP.bias_cells)
    require(len(mapped.col_tiles) == 4, "784 bits should take four tiles")
    head = ensemble.build_head(folded[-1], PAPER_ENSEMBLE).to(dev)
    xm = torch.from_numpy(r["x"])
    mapping_row = {}
    for mode in ("exact", "hierarchical"):
        h = mapping.layer_forward(mapped, xm.to(dev), mode)
        require(h.device == dev and torch.equal(
            h.cpu(), mapping.layer_forward(mapped, xm, mode)),
            f"layer_forward[{mode}] on the card != CPU")
        pred = ensemble.predict(head, h, PAPER_ENSEMBLE)
        mapping_row[f"{mode}_top1"] = float(
            (pred.cpu().numpy() == data["mnist"]["vy"]).mean())
    print(f"  mapping mnist_mlp 784 bits -> 4 tiles of 256: card == CPU; "
          f"top-1 exact {mapping_row['exact_top1']:.4f}, hierarchical "
          f"{mapping_row['hierarchical_top1']:.4f}")

    # ---- binary_gemm_mxu (torch._int_mm) against its plain version
    rng = np.random.default_rng(SEED + 11)
    mxu_err = 0
    for m in (1, 15, 17, 4096):
        for k, n in ((785, 128), (4095, 20), (100, 3)):
            xw = torch.from_numpy(rng.choice([-1.0, 1.0], (m, k)).astype(
                np.float32))
            ww = torch.from_numpy(rng.choice([-1.0, 1.0], (k, n)).astype(
                np.float32))
            got = ops.binary_gemm_mxu(xw.to(dev), ww.to(dev)).cpu()
            want = ops.binary_gemm_mxu_plain(xw, ww)
            require(torch.equal(got, want),
                    f"binary_gemm_mxu M={m} K={k} N={n} != plain")
            mxu_err = max(mxu_err, int((got - want).abs().max()))
    print("  binary_gemm_mxu == plain at M in (1, 15, 17, 4096), K in "
          "(785, 4095, 100)")

    # ---- Table II: the 65 nm macro's modelled figures, not the card's
    table2 = {}
    for mid, _, cfg, kind in models:
        if kind == "mlp":
            sizes = cfg.layer_sizes
            cost = mapping.model_inference_cost(
                [mapping.plan_layer(b, a, cfg.bias_cells)
                 for a, b in zip(sizes[:-1], sizes[1:])],
                len(PAPER_ENSEMBLE.thresholds))
        else:
            cost = convnet.cnn_inference_cost(cfg)
        table2[mid] = dict(
            inf_per_s=cost.inferences_per_s, nj_per_inf=cost.energy_j * 1e9,
            inf_per_s_per_w=1.0 / cost.energy_j, cycles=cost.cycles,
            binary_ops=cost.binary_ops)
        print(f"  Table II model (65 nm macro, 25 MHz, 0.8 mW; not the "
              f"card) {mid:9s}: {cost.inferences_per_s:,.0f} inf/s, "
              f"{cost.energy_j * 1e9:.3f} nJ/inf, "
              f"{1.0 / cost.energy_j:,.0f} inf/s/W, {cost.cycles} cycles")
    mn = table2["mnist_mlp"]
    # tests/test_mapping.py's band around the paper's 560 K inf/s and
    # 703 M inf/s/W (tests/test_torch_mapping.py holds it equal to JAX's)
    require(500e3 <= mn["inf_per_s"] <= 700e3
            and 300e6 <= mn["inf_per_s_per_w"] <= 1.5e9,
            f"MNIST MLP Table II out of the paper's band: {mn}")
    phase_s = time.perf_counter() - t_phase
    print(f"train phase: {phase_s:.1f} s")
    return dict(
        models={mid: r["row"] for mid, r in results.items()},
        profile=steps_split, phase_s=phase_s,
        grad_check=grad, mapping=mapping_row,
        binary_gemm_mxu=dict(max_abs_err=mxu_err, route="torch._int_mm"),
        table2_macro_model=table2, launches=launches, card=smi)


# ------------------------------------------------------------ LM phase (7)
# The LM serving workload: 8 requests of 16 prompt tokens, 16 new tokens
# each, in batches of 4 (the reference launcher's defaults)
LM_REQUESTS, LM_PROMPT, LM_NEW, LM_BATCH = 8, 16, 16, 4
# bf16 logits, teacher-forced decode against forward over the same
# sequence: decode rounds the query to bf16 where forward keeps it in
# float32 (the reference's two attention paths; the reference's decode
# rounds its softmax weights too) and every projection rounds its output
# to bf16, so through
# 16-48 layers logits of O(1-5) move by a few hundredths.  A BitLinear
# FFN binarizes its inputs: an input within that rounding of 0 flips its
# sign between the two paths and moves every output of the projection by
# a step of 2 * alpha * beta, so its logits move by a few tenths (0.54
# max, 0.10 RMS against an RMS logit of 1.0 at llama3.2-1b, NVIDIA H100
# 80GB HBM3, 700 W).  Greedy tokens must equal forward's argmax where its
# top-2 margin exceeds twice the tolerance (each logit may move by it).
LM_ATOL, LM_ATOL_BITLINEAR = 0.25, 1.0
# Top-k routing is a step function too: the rounding that separates the
# two paths can swap a token's expert between two nearly tied router
# probabilities, which moves that token's logits by O(1) (3.28 at
# mixtral-8x7b, 2 blocks, bf16, NVIDIA H100 80GB HBM3, 700 W).  An MoE
# model's bf16 difference is reported, and the pointwise check runs on a
# float32 copy of the same weights, where a swap needs a tie within
# float32 rounding; there the two paths differ by float32 rounding.
LM_MOE_F32_ATOL = 1e-3
# llama3.2-1b at full width, 2 blocks, float32 (TF32 off): card against
# CPU, the same arithmetic in another summation order; the BitLinear
# projections on the same inputs (kernel 1 against the plain route)
LM_F32_ATOL, LM_F32_RTOL = 1e-4, 1e-4
# device ms of kernels 1 and 2 at the LM shapes in the previous version of
# the kernels (NVIDIA H100 80GB HBM3, 700 W), printed beside this run's as
# "prev": the BitLinear prefill (M = 64 and 32,768) and decode (M = 4, 1)
# projections, the CAM heads at decode
LM_PREV_MS = {"x[64,64] w[8192,64]": 0.0052, "x[64,256] w[2048,256]": 0.0097,
              "x[4,64] w[8192,64]": 0.0037, "x[4,256] w[2048,256]": 0.0090,
              "x[32768,64] w[8192,64]": 1.0917,
              "x[32768,256] w[2048,256]": 0.7327,
              "x[1,64] w[8192,64]": 0.0037, "x[1,256] w[2048,256]": 0.0091,
              "q[4,64] rows[128256,64]": 2.9669,
              "q[1,64] rows[128256,64]": 2.9092,
              "q[4,48] rows[2048,48]": 0.0338}
# the previous version's decode ms a token (phase 7: llama3.2-1b plain /
# +binary-ffn / +cam-head) and long-context prefill s and decode ms a
# token (the same card), printed beside this run's; reported, not gated
LM_PREV_DECODE_MS = {"llama3.2-1b": 34.27, "llama3.2-1b+binary-ffn": 61.01,
                     "llama3.2-1b+cam-head": 50.19}
LONG_PREV = dict(prefill_s=11.40, decode_ms=(362.82, 521.06))
# kernel 2's query tiles at the vocabulary head, and kernel 1's plan
# boundaries: (M, N, Kw) at the large tile's N >= 256 and three 32 x 128
# blocks an SM (264 blocks, 266), at split_k's M <= 16 and Kw >= 64
LM_EDGE_B = (1, 16, 17, 32)
GEMM_EDGES = ((4224, 256, 64), (4225, 256, 64), (4225, 255, 64),
              (16, 2048, 64), (17, 2048, 64), (4, 2048, 63), (4, 2048, 64))


def lm_requests(cfg, seed: int) -> list:
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, LM_PROMPT)
                    .astype(np.int32), max_new_tokens=LM_NEW)
            for i in range(LM_REQUESTS)]


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def lm_engine_run(cfg, params, seed: int, dev, on_card: bool):
    """`Engine.generate` over the workload twice (the first warms the
    handles, the libraries and the packed weights; both are on the
    path), no device argument on the card.  Returns (results of the
    second, its prefill ms, decode ms per token, tokens/s)."""
    from repro_torch.serve.engine import Engine, EngineConfig

    eng = Engine(cfg, params, EngineConfig(max_batch=LM_BATCH, eos_id=-1),
                 **({} if on_card else {"device": dev}))
    require(eng.device == dev, f"{cfg.name}: Engine() not on the card")
    eng.generate(lm_requests(cfg, seed))
    sync(dev)
    t0 = time.perf_counter()
    res = eng.generate(lm_requests(cfg, seed))
    sync(dev)
    wall = time.perf_counter() - t0
    heads = res[::LM_BATCH]  # one Result per batch carries its timings
    return res, dict(
        prefill_ms=float(np.mean([r.prefill_ms for r in heads])),
        decode_ms_per_token=float(np.mean([r.decode_ms / (LM_NEW - 1)
                                           for r in heads])),
        tokens_per_s=sum(len(r.tokens) for r in res) / wall,
        requests=len(res), new_tokens=sum(len(r.tokens) for r in res))


def lm_steps_run(cfg, params, seq):
    """prefill on the first LM_PROMPT positions of seq (tokens [B, T] or
    frame embeddings [B, T, D]), then one decode step per later position
    (teacher-forced).  Returns (float32 [B, T - LM_PROMPT + 1, V], prefill
    ms, decode ms per step)."""
    from repro_torch.serve import steps

    key = "embeds" if cfg.embeds_input else "tokens"
    s, dev = LM_PROMPT, seq.device
    n = seq.shape[1] - s + 1
    t0 = time.perf_counter()
    lg, cache = steps.prefill_step(cfg, params, {key: seq[:, :s]},
                                   max_len=s + n)
    sync(dev)
    t1 = time.perf_counter()
    out = [lg]
    for i in range(n - 1):
        lg, cache = steps.decode_step(cfg, params, cache, seq[:, s + i:
                                                              s + i + 1],
                                      s + i)
        out.append(lg)
    sync(dev)
    t2 = time.perf_counter()
    return torch.stack(out, 1), (t1 - t0) * 1e3, (t2 - t1) * 1e3 / (n - 1)


def decode_and_forward(cfg, params, seq):
    """Teacher-forced decode logits (`lm_steps_run`) and `forward`'s at
    the same positions, both float32 [B, T - LM_PROMPT + 1, V]."""
    from repro_torch.models import model as M

    tf, _, _ = lm_steps_run(cfg, params, seq)
    kw = {"embeds" if cfg.embeds_input else "tokens": seq}
    return tf, M.forward(params, cfg, **kw)[0][:, LM_PROMPT - 1:]


def lm_kernel_rows(card, name, cases) -> list:
    """Each (label, kernel, plain, library, work) case: kernel ==
    plain == library (torch.equal), then device, call, plain and library
    times beside the bound of `work` (Card.bound_ms arguments)."""
    rows = []
    for label, fn, plain, lib, work, lib_name in cases:
        got, want = fn(), plain()
        require(torch.equal(got, want), f"{name} {label}: kernel != plain")
        require(torch.equal(lib().to(got.dtype), got),
                f"{name} {label}: {lib_name} != kernel")
        row = dict(shape=label, ms=device_ms(fn, iters=20),
                   call_ms=time_ms(fn, 20), plain_ms=time_ms(plain, 3),
                   **bound_fields(card, *work),
                   library_ms=device_ms(lib, iters=20), library=lib_name,
                   max_abs_err=int((got - want).abs().max()))
        rows.append(row)
        prev = next((v for k, v in LM_PREV_MS.items() if k in label), None)
        print(f"  LM {name} {label}: == plain == library; kernel "
              f"{row['ms']} ms (prev {prev}; call "
              f"{row['call_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_route']}), {lib_name} {row['library_ms']} ms")
    return rows


def gemm_case(label, q, w):
    """Kernel 1 on q [M, Kw] against w [N, Kw]; library: the reference's
    float32 ±1 product (TF32 off) of the unpacked operands, as HD."""
    from repro_torch.core import binarize
    from repro_torch.kernels import binary_gemm

    (m, kw), n = q.shape, w.shape[0]
    k = 32 * kw
    xf = binarize.unpack_bits(q, k).float() * 2 - 1
    wf = (binarize.unpack_bits(w, k).float() * 2 - 1).t().contiguous()
    pairs = m * n * kw
    return (f"{label} x[{m},{kw}] w[{n},{kw}]",
            lambda: binary_gemm.binary_gemm_hd(q, w),
            lambda: binary_gemm.binary_gemm_hd_plain(q, w),
            lambda: ((k - torch.matmul(xf, wf)) * 0.5),
            (pairs, 2 * pairs, 4 * (m * kw + n * kw + m * n), 32 * pairs, 0),
            "float32 ±1 torch.matmul")


def vote_case(label, q, rows, thr):
    """Kernel 2 on q [B, Kw] against rows [C, Kw], int [P] schedule;
    library: the reference's ±1 product (float32, exact) then the
    threshold compare."""
    from repro_torch.core import binarize
    from repro_torch.kernels import cam_search

    (b, kw), c, p = q.shape, rows.shape[0], thr.shape[0]
    k = 32 * kw
    hf = binarize.unpack_bits(q, k).float() * 2 - 1
    rf = (binarize.unpack_bits(rows, k).float() * 2 - 1).t().contiguous()
    tf = thr.float()
    pairs, vote = b * c * kw, 2 * b * c * p
    return (f"{label} q[{b},{kw}] rows[{c},{kw}] P={p}",
            lambda: cam_search.cam_vote(q, rows, thr),
            lambda: cam_search.cam_vote_plain(q, rows, thr),
            lambda: (((k - torch.matmul(hf, rf)) * 0.5)[..., None]
                     <= tf).sum(-1),
            (pairs, 2 * pairs + vote, 4 * (b * kw + c * kw + p + b * c),
             32 * pairs, vote),
            "float32 ±1 torch.matmul + compare")


def bitlinear_cases(model, prompts) -> list:
    """Kernel 1's cases at a BitLinear model's shapes (`gemm_case`): its
    first FFN's w_gate and w_down projections at prefill (LM_BATCH x
    LM_PROMPT tokens) and decode (LM_BATCH tokens), on the model's packed
    rows and the embedded prompts (w_up has w_gate's shapes)."""
    from repro_torch.models import binary_lm

    ffn, cases = model.blocks[0].sub0.ffn, []
    with torch.no_grad():
        for label, m in (("prefill", LM_BATCH * LM_PROMPT),
                         ("decode", LM_BATCH)):
            x = model.embed[prompts.to(model.device)].reshape(
                -1, model.cfg.d_model)[:m]
            act = torch.nn.functional.silu(binary_lm._bit_matmul_packed(
                ffn, "w_gate", x).float()).to(x.dtype) \
                * binary_lm._bit_matmul_packed(ffn, "w_up", x)
            for name, q in (("w_gate", x), ("w_down", act)):
                rows = binary_lm.bitlinear_weights(ffn, name)[0]
                cases.append(gemm_case(f"BitLinear {label} {name}",
                                       binary_lm.sign_bits(q), rows))
    return cases


def direct_hd(x, w):
    """Kernel 1 as its wrapper launched it before it became the custom op
    `repro_torch::binary_gemm_hd`: the same checks, then the ctypes
    launch called straight (the plain version for CPU tensors)."""
    from repro_torch.kernels import binary_gemm as bg

    bg._check_words("x_packed", x)
    bg._check_words("w_packed", w)
    if x.shape[1] != w.shape[1] or x.device != w.device:
        raise ValueError("operands do not pair")
    return bg.launch(x, w) if x.is_cuda else bg.binary_gemm_hd_plain(x, w)


def direct_vote(q, rows, thr, *, thr_samples=None):
    """Kernel 2 as `direct_hd` is kernel 1 (`repro_torch::cam_vote`)."""
    from repro_torch.kernels import cam_search as cs

    cs._check_words("q_packed", q)
    cs._check_words("rows_packed", rows)
    if q.shape[1] != rows.shape[1] or q.device != rows.device:
        raise ValueError("operands do not pair")
    thr = cs.normalize_thresholds(thr).to(q.device).contiguous()
    if thr_samples is not None:
        thr_samples = cs.check_samples(thr_samples, q.shape[0],
                                       rows.shape[0], thr.shape[0])
    return (cs.launch(q, rows, thr, thr_samples) if q.is_cuda
            else cs.cam_vote_plain(q, rows, thr, thr_samples))


@contextlib.contextmanager
def direct_launches():
    """`kernels.ops`' kernel 1 and 2 wrappers replaced by `direct_hd` and
    `direct_vote`: the same launches without the op dispatch, to time
    what the dispatch costs a step."""
    from repro_torch.kernels import ops

    saved = ops.binary_gemm_hd, ops.cam_vote
    ops.binary_gemm_hd, ops.cam_vote = direct_hd, direct_vote
    try:
        yield
    finally:
        ops.binary_gemm_hd, ops.cam_vote = saved


# the decode runs timed with the kernels' wrappers launching straight and
# through the custom ops, alternating
AB_KEYS = ("llama3.2-1b+binary-ffn", "llama3.2-1b+cam-head", "llama3.2-1b")


def lm_phase(dev, smi: str, card, counted, quick: bool) -> dict:
    """Phase 7: the LM serving path (`repro_torch.models`, `serve.engine`).

    With every launch count set to 0 just before: llama3.2-1b at full
    width and depth (16 blocks, bf16, V = 128,256) three ways (plain,
    +binary-ffn: BitLinear FFN on kernel 1, +cam-head: Algorithm 1 as the
    decode head on kernel 2), each through `Engine.generate` with no
    device argument; musicgen-medium+cam-head at full width and depth
    (48 blocks, V = 2,048) through `prefill_step`/`decode_step` on random
    frame embeddings; mixtral-8x7b (MoE; capacity factor 8, so prefill,
    decode and forward all route without drops) and falcon-mamba-7b
    (SSM) at full width, 2 blocks, through `Engine.generate`.  Kernels 1
    and 2 must have launched.  Then the checks: each kernel equal to its
    plain version (and to the library's ±1 product) at every LM shape of
    the path, on the model's packed rows, and at the launch plans' edges
    (LM_EDGE_B, GEMM_EDGES); decode logits, teacher-forced,
    within LM_ATOL of `forward` over the generated sequence; the
    engine's tokens equal to the teacher-forced argmax and to forward's
    where its top-2 margin exceeds 2 * LM_ATOL; llama3.2-1b at full
    width, 2 blocks, float32: card == CPU within LM_F32_*.  `quick` (a
    CPU rehearsal) takes the `+smoke` configs."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import binary_lm
    from repro_torch.models import model as M
    from repro_torch.models.layers import MLP

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    smoke = "+smoke" if quick else ""

    def cut(name, **kw):  # full width; depth cut where asked
        return dataclasses.replace(configs.get_config(name + smoke), **kw)

    gen = torch.Generator(dev).manual_seed(SEED + 21)
    here = {} if on_card else {"device": dev}
    served = {"llama3.2-1b" + v: cut("llama3.2-1b" + v)
              for v in ("", "+binary-ffn", "+cam-head")}
    served["mixtral-8x7b/2"] = cut("mixtral-8x7b", n_layers=2,
                                   capacity_factor=8.0)
    served["falcon-mamba-7b/2"] = cut("falcon-mamba-7b", n_layers=2)
    mg_cfg = cut("musicgen-medium+cam-head")
    t0 = time.perf_counter()
    params = {k: M.init_params(c, gen, **here) for k, c in served.items()}
    mg = M.init_params(mg_cfg, gen, **here)
    require(all(p.device == dev for p in params.values()),
            "init_params() with no device did not land on the card")
    sync(dev)
    print(f"lm: {len(params) + 1} models drawn on {dev} in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{sum(c.param_count() for c in served.values()) / 1e9:.2f} + "
          f"{mg_cfg.param_count() / 1e9:.2f} B parameters")
    frames = torch.randn((LM_BATCH, LM_PROMPT + LM_NEW - 1, mg_cfg.d_model),
                         generator=gen, device=dev)

    # ------------------------------------ the LM path, counts from 0
    for fn in counted:
        fn.launches = 0
    out, perf = {}, {}
    for key, cfg in served.items():
        out[key], perf[key] = lm_engine_run(cfg, params[key], SEED + 22,
                                            dev, on_card)
    lm_steps_run(mg_cfg, mg, frames)  # warm
    mg_votes, pre, dec = lm_steps_run(mg_cfg, mg, frames)
    perf["musicgen-medium+cam-head"] = dict(
        prefill_ms=pre, decode_ms_per_token=dec,
        tokens_per_s=LM_BATCH * LM_NEW / ((pre + dec * (LM_NEW - 1)) / 1e3),
        requests=LM_BATCH, new_tokens=LM_BATCH * LM_NEW)
    sync(dev)
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"LM path: launches {launches}")
    for name in ("binary_gemm_hd", "cam_vote"):
        require(launches[name] > 0 or not on_card,
                f"{name} was not launched on the LM path")
    for key, p in perf.items():
        print(f"  {key:26s} prefill {p['prefill_ms']:.2f} ms, decode "
              f"{p['decode_ms_per_token']:.3f} ms/token (prev "
              f"{LM_PREV_DECODE_MS.get(key)}), "
              f"{p['tokens_per_s']:.1f} tokens/s ({p['requests']} requests, "
              f"{p['new_tokens']} new tokens; {smi})")
    # the custom ops' dispatch in this one call: each op against its
    # launch called straight (the wrapper before the op) at the decode
    # step's shapes, per call (host-bound there); then decode ms a token
    # of +binary-ffn (48 kernel-1 calls a step), +cam-head (one kernel-2
    # call a step) and the plain model (no kernel: the run-to-run
    # spread), the two ways alternating
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import cam_search as cs

    g = torch.Generator(dev).manual_seed(SEED + 23)

    def words(*shape):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                             dtype=torch.int32, device=dev)

    # kernel 1 at the BitLinear decode shape; kernel 2 at a few rows, so
    # the call, not the device, sets its time
    q, w = words(LM_BATCH, 64), words(8192, 64)
    qc, rows = words(LM_BATCH, 64), words(256, 64)
    thr = torch.arange(1008, 1041, dtype=torch.int32, device=dev)
    dispatch = {"call_us": {
        "binary_gemm_hd": {
            "custom_op": time_ms(lambda: bg.binary_gemm_hd(q, w), 200) * 1e3,
            "direct": time_ms(lambda: direct_hd(q, w), 200) * 1e3},
        "cam_vote": {
            "custom_op": time_ms(lambda: cs.cam_vote(qc, rows, thr),
                                 200) * 1e3,
            "direct": time_ms(lambda: direct_vote(qc, rows, thr),
                              200) * 1e3}}}
    for key in AB_KEYS:
        ms = {"direct": [], "custom_op": []}
        for mode in ("direct", "custom_op") * 3:
            with (direct_launches() if mode == "direct"
                  else contextlib.nullcontext()):
                _, p = lm_engine_run(served[key], params[key], SEED + 22,
                                     dev, on_card)
            ms[mode].append(p["decode_ms_per_token"])
        dispatch[key] = ms
    for name, v in dispatch["call_us"].items():
        print(f"  {name} a call at the decode shapes: through the custom op "
              f"{v['custom_op']:.2f} us, launched straight {v['direct']:.2f}"
              f" us ({smi})")
    for key in AB_KEYS:
        print(f"  {key:26s} decode ms/token, launches straight "
              f"{dispatch[key]['direct']}, through the custom ops "
              f"{dispatch[key]['custom_op']} ({smi})")

    # ---------------------------------- kernels at the LM path's shapes
    bl = params["llama3.2-1b+binary-ffn"]
    cam = params["llama3.2-1b+cam-head"]
    k2 = []
    with torch.no_grad():
        prompts = torch.from_numpy(np.stack(
            [r.prompt for r in lm_requests(bl.cfg, SEED + 22)]))
        k1 = bitlinear_cases(bl, prompts)
        # the CAM heads' queries: the sign bits of the final hidden state
        # at the last position of a generated sequence
        seq = torch.cat([prompts[:LM_BATCH].to(dev), torch.tensor(
            [r.tokens[:-1] for r in out["llama3.2-1b+cam-head"][:LM_BATCH]],
            device=dev)], 1)
        h_cam, _ = M.final_hidden(cam, cam.cfg, tokens=seq)
        h_mg, _ = M.final_hidden(mg, mg_cfg, embeds=frames)
        for label, model, h in (("llama3.2-1b", cam, h_cam[:, -1]),
                                ("musicgen-medium", mg, h_mg[:, -1])):
            rows = binary_lm.packed_rows(model.cam_head, "rows",
                                         model.cam_head.rows)
            k2.append(vote_case(f"CAM head {label}", binary_lm.sign_bits(h),
                                rows, model.cam_head.thresholds))
        # kernel 2 at the vocabulary plan's query tiles (B = 1, 16: one
        # 16-query tile; 17, 32: one of 32) on the CAM head's own rows,
        # kernel 1 at its plans' boundaries (random words)
        rows = binary_lm.packed_rows(cam.cam_head, "rows", cam.cam_head.rows)
        for b in LM_EDGE_B:
            k2.append(vote_case(f"CAM head edge", words(b, rows.shape[1]),
                                rows, cam.cam_head.thresholds))
        for m, n, kw in GEMM_EDGES:
            plan = bg.gemm_plan(m, n, kw, sms=card.sms)["plan"]
            k1.append(gemm_case(f"plan edge {plan}", words(m, kw),
                                words(n, kw)))
        lm_rows = {"binary_gemm_hd": lm_kernel_rows(card, "binary_gemm_hd",
                                                    k1),
                   "cam_vote": lm_kernel_rows(card, "cam_vote", k2)}
        del k1, k2

    # --------------------------- decode against forward, tokens, logits
    errs = {}
    with torch.no_grad():
        for key, cfg in list(served.items()) + [("musicgen-medium+cam-head",
                                                 mg_cfg)]:
            model = mg if key.startswith("musicgen") else params[key]
            if cfg.embeds_input:
                seqs_b = [frames]
            else:
                reqs = lm_requests(cfg, SEED + 22)
                res = out[key]
                seqs_b = [torch.cat([
                    torch.from_numpy(np.stack([r.prompt for r in
                                               reqs[i:i + LM_BATCH]])),
                    torch.tensor([r.tokens[:-1]
                                  for r in res[i:i + LM_BATCH]])], 1).to(dev)
                    for i in range(0, LM_REQUESTS, LM_BATCH)]
            plain_head = dataclasses.replace(cfg, cam_head=False)
            moe = cfg.n_experts > 0
            tol = (None if moe else LM_ATOL_BITLINEAR if cfg.binary_ffn
                   else LM_ATOL)
            worst, sq, n_el, sure_n, sure_all = 0.0, 0.0, 0, 0, 0
            for j, seq in enumerate(seqs_b):
                tf, fw = decode_and_forward(plain_head, model, seq)
                require(tf.shape == fw.shape and bool(torch.isfinite(tf)
                                                      .all()),
                        f"{key}: decode logits {tuple(tf.shape)} not finite")
                worst = max(worst, float((tf - fw).abs().max()))
                sq += float((tf - fw).pow(2).sum())
                n_el += tf.numel()
                if cfg.embeds_input:
                    votes = mg_votes[:, 1:]
                    require(bool(((votes >= 0) & (votes <= cfg.
                                                  cam_head_thresholds)
                                  & (votes == votes.round())).all()),
                            f"{key}: CAM-head votes outside 0..P")
                    continue
                toks = torch.tensor([r.tokens for r in
                                     out[key][j * LM_BATCH:
                                              (j + 1) * LM_BATCH]],
                                    device=dev)
                # the engine's tokens: the argmax of the same decode steps
                again = tf if not cfg.cam_head else lm_steps_run(
                    cfg, model, seq)[0]
                require(torch.equal(again.argmax(-1), toks),
                        f"{key}: engine tokens != teacher-forced argmax")
                if moe:
                    continue
                top2 = fw.topk(2, -1).values
                sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
                if cfg.cam_head:
                    sure[:, 1:] = False  # decode reads votes, not logits
                require(torch.equal(fw.argmax(-1)[sure], toks[sure]),
                        f"{key}: greedy tokens != forward's argmax where "
                        f"the margin exceeds {2 * tol}")
                sure_n += int(sure.sum())
                sure_all += sure.numel()
            require(tol is None or worst <= tol, f"{key}: decode vs forward "
                    f"max |dlogit| {worst:.4f} > {tol}")
            rms = (sq / n_el) ** 0.5
            errs[key] = dict(decode_vs_forward_max_abs=worst,
                             decode_vs_forward_rms=rms, tol=tol,
                             tokens_checked_vs_forward=sure_n,
                             tokens=sure_all)
            if moe:  # the pointwise check on a float32 copy
                cfg32 = dataclasses.replace(plain_head, dtype="float32")
                twin = M.CausalLM(cfg32, dev)
                twin.load_state_dict(model.state_dict())
                worst32 = max(float((a - b).abs().max()) for a, b in (
                    decode_and_forward(cfg32, twin, seq) for seq in seqs_b))
                del twin
                require(worst32 <= LM_MOE_F32_ATOL,
                        f"{key}: float32 copy, decode vs forward max "
                        f"|dlogit| {worst32:.2e} > {LM_MOE_F32_ATOL}")
                errs[key].update(f32_decode_vs_forward_max_abs=worst32,
                                 f32_tol=LM_MOE_F32_ATOL)
                print(f"  {key:26s} float32 copy: decode vs forward max "
                      f"|dlogit| {worst32:.2e} (tol {LM_MOE_F32_ATOL})")
            print(f"  {key:26s} decode vs forward max |dlogit| {worst:.4f}"
                  f" ({'reported' if moe else f'tol {tol}'}), RMS "
                  f"{rms:.4f}; " + (
                      "votes in 0..P" if cfg.embeds_input else
                      "engine tokens == teacher-forced argmax; == forward "
                      f"argmax at {sure_n}/{sure_all} positions past the "
                      "margin"))

        # llama3.2-1b, full width, 2 blocks, float32: card against CPU
        cfg32 = cut("llama3.2-1b", n_layers=2, dtype="float32")
        m32 = M.init_params(cfg32, gen, **here)
        cpu32 = M.CausalLM(cfg32, "cpu")
        cpu32.load_state_dict({k: v.cpu() for k, v in
                               m32.state_dict().items()})
        toks = prompts[:2]
        got = M.forward(m32, cfg32, tokens=toks.to(dev))[0].cpu()
        want = M.forward(cpu32, cfg32, tokens=toks)[0]
        f32_err = float((got - want).abs().max())
        require(bool(((got - want).abs() <= LM_F32_ATOL
                      + LM_F32_RTOL * want.abs()).all()),
                f"llama3.2-1b f32 2 blocks: card != CPU (max {f32_err})")
        print(f"  llama3.2-1b, 2 blocks, float32: card == CPU, max |d| "
              f"{f32_err:.2e} (tol {LM_F32_ATOL} + {LM_F32_RTOL}|cpu|)")
        # the BitLinear projections at full width on the same inputs:
        # kernel 1 on the card, the plain route on the CPU
        bit32 = cut("llama3.2-1b+binary-ffn", n_layers=2, dtype="float32")
        ffn, ffn_cpu = MLP(bit32, dev), MLP(bit32, "cpu")
        ffn.draw(gen)
        ffn_cpu.load_state_dict({k: v.cpu() for k, v in
                                 ffn.state_dict().items()})
        x = torch.randn((LM_BATCH * LM_PROMPT, bit32.d_model),
                        generator=gen, device=dev)
        act = torch.randn((LM_BATCH * LM_PROMPT, bit32.d_ff),
                          generator=gen, device=dev)
        for name, q in (("w_gate", x), ("w_up", x), ("w_down", act)):
            got = binary_lm._bit_matmul_packed(ffn, name, q).cpu()
            want = binary_lm._bit_matmul_packed(ffn_cpu, name, q.cpu())
            require(bool(((got - want).abs() <= LM_F32_ATOL
                          + LM_F32_RTOL * want.abs()).all()),
                    f"BitLinear {name} float32: card != CPU")
            f32_err = max(f32_err, float((got - want).abs().max()))
        print(f"  BitLinear w_gate/w_up/w_down at full width, float32, same "
              f"inputs: card (kernel 1) == CPU (plain); max |d| incl. the "
              f"model {f32_err:.2e}")
    del params, mg, m32, cpu32, ffn, ffn_cpu
    if on_card:
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"LM phase: {phase_s:.1f} s")
    return dict(launches=launches, perf=perf, kernels=lm_rows, checks=errs,
                custom_op_dispatch=dispatch,
                f32_card_vs_cpu_max_abs=f32_err, phase_s=phase_s, card=smi,
                workload=dict(requests=LM_REQUESTS, prompt=LM_PROMPT,
                              max_new=LM_NEW, batch=LM_BATCH))


# Phase 7's long context: one sequence of LONG_S tokens through
# `prefill_step`, then LONG_DECODE decode steps over that cache (full
# width and depth, bf16); the card-against-CPU check on a 2-block float32
# cut at LONG_CHECK_S
LONG_ARCH = "llama3.2-1b+binary-ffn+cam-head"
LONG_S, LONG_DECODE, LONG_CHECK_S = 32768, 4, 2048


def operand_key(name: str, args, kw) -> tuple:
    """(kernel name, the shape and type of each tensor operand, a
    sequence of tensors as the tuple of its shapes, then each tensor
    keyword's name and shape): one key for each form of a call."""
    def of(a):
        if torch.is_tensor(a):
            return tuple(a.shape), str(a.dtype)
        if isinstance(a, (list, tuple)) and all(map(torch.is_tensor, a)):
            return tuple(tuple(t.shape) for t in a)
        return None
    return (name, *(of(a) for a in args if of(a) is not None),
            *((k, tuple(v.shape)) for k, v in sorted(kw.items())
              if torch.is_tensor(v)))


@contextlib.contextmanager
def first_operands(seen: dict, calls: dict | None = None):
    """The kernels' wrappers keeping, in seen, the operands (args, kwargs)
    of their first call of each form (`operand_key`), and calling the
    wrapper as before; `calls` counts each kernel's calls.  Kernels 1
    and 2 are caught at `kernels.ops`, where the port calls them, kernels
    3 and 4 and 4's stage entry in their own modules, where their bodies
    count a launch through the module's name, which then names the
    catching function: each call hands that count on to the wrapper.
    One call at a time (a server's thread launches beside the caller's)."""
    import threading

    from repro_torch.kernels import fused_conv, fused_mlp, ops

    sites = [(ops, "binary_gemm_hd"), (ops, "cam_vote"),
             (fused_mlp, "fused_mlp_votes"), (fused_conv, "fused_conv_votes"),
             (fused_conv, "conv_stage_packed")]
    saved = [getattr(mod, name) for mod, name in sites]
    calls = {} if calls is None else calls
    lock = threading.RLock()

    def keep(name, fn):
        def call(*args, **kw):
            with lock:
                seen.setdefault(operand_key(name, args, kw), (args, kw))
                calls[name] = calls.get(name, 0) + 1
                call.launches = 0
                try:
                    return fn(*args, **kw)
                finally:
                    if call.launches:
                        fn.launches += call.launches
        return call

    for (mod, name), fn in zip(sites, saved):
        setattr(mod, name, keep(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(sites, saved):
            setattr(mod, name, fn)


def lm_long_phase(dev, smi: str, card, counted, quick: bool) -> dict:
    """Phase 7, long context: llama3.2-1b+binary-ffn+cam-head at full
    width and depth (bf16) prefills one sequence of LONG_S = 32,768
    tokens through `prefill_step` (the chunked online-softmax attention,
    `attn_chunk` keys at a time) and decodes LONG_DECODE tokens over that
    cache (read in its stored bf16 layout a chunk at a time), every
    launch count set to 0 just before: kernel 1 (the BitLinear FFN) must
    launch in the prefill and in every decode step, kernel 2 (the CAM
    head) in every decode step.  Prints the prefill's seconds, decode ms
    a token, `torch.cuda.max_memory_allocated`, and beside it the bytes
    of one layer's [B, H, S, S] float32 scores, which the unchunked form
    would hold.  Checks: the prefill's logits finite, the votes integers
    in 0..P; kernels 1 and 2 on the operands of their first call of each
    shape on the path (`first_operands`: BitLinear at M = LONG_S in the
    prefill and M = 1 in decode, the CAM head at B = 1) equal to their
    plain versions and the library call (`lm_kernel_rows`, which times
    them).  Then llama3.2-1b at 2 blocks, float32, prefills
    LONG_CHECK_S = 2,048 tokens and decodes LONG_DECODE on the card and
    on the CPU: every step's logits equal within LM_F32_ATOL +
    LM_F32_RTOL |cpu| (the same arithmetic in another summation order,
    as phase 7's float32 forward).  `quick` (a CPU rehearsal) takes the
    `+smoke` configs at 256 and 64 tokens."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve import steps

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    smoke = "+smoke" if quick else ""
    s, s_check = (256, 64) if quick else (LONG_S, LONG_CHECK_S)
    here = {} if on_card else {"device": dev}
    cfg = configs.get_config(LONG_ARCH + smoke)
    gen = torch.Generator(dev).manual_seed(SEED + 24)
    params = M.init_params(cfg, gen, **here)
    tokens = torch.randint(1, cfg.vocab_size, (1, s + LONG_DECODE),
                           generator=gen, dtype=torch.int32, device=dev)
    reset_peak(dev)

    # -------------------------- the long-context path, counts from 0
    for fn in counted:
        fn.launches = 0

    def counts():
        return {fn.__name__: fn.launches for fn in counted}

    seen: dict = {}
    with first_operands(seen):
        t0 = time.perf_counter()
        logits, cache = steps.prefill_step(cfg, params,
                                           {"tokens": tokens[:, :s]},
                                           max_len=s + LONG_DECODE)
        sync(dev)
        prefill_s = time.perf_counter() - t0
        per_step = [counts()]
        decode_ms, votes = [], []
        for i in range(LONG_DECODE):
            before = counts()
            t0 = time.perf_counter()
            v, cache = steps.decode_step(cfg, params, cache,
                                         tokens[:, s + i:s + i + 1], s + i)
            sync(dev)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            votes.append(v)
            per_step.append({k: n - before[k] for k, n in counts().items()})
    peak = peak_gb(dev)
    launches = counts()
    scores_gb = 1 * cfg.n_heads * s * s * 4 / 1e9
    dec = [round(x, 2) for x in decode_ms]
    print(f"lm long context: {cfg.name}, prefill B = 1, S = {s}: "
          f"{prefill_s:.2f} s (prev {LONG_PREV['prefill_s']}); decode ms a "
          f"token {dec} (prev {LONG_PREV['decode_ms']}); "
          f"max_memory_allocated {peak} GB against "
          f"{scores_gb:.1f} GB of one layer's S x S float32 scores; "
          f"launches {launches}, per step {per_step} ({smi})")
    for name in ("binary_gemm_hd", "cam_vote"):
        require(launches[name] > 0 or not on_card,
                f"{name} was not launched on the long-context path")
    require(not on_card or (per_step[0]["binary_gemm_hd"] > 0 and all(
        st["binary_gemm_hd"] > 0 and st["cam_vote"] > 0
        for st in per_step[1:])),
        f"long context: a step without its kernels: {per_step}")
    require(logits.shape == (1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"long context: prefill logits {tuple(logits.shape)} not finite")
    for v in votes:
        require(bool(((v >= 0) & (v <= cfg.cam_head_thresholds)
                      & (v == v.round())).all()),
                "long context: CAM-head votes outside 0..P")
    # kernels 1 and 2 on the path's own operands, against their plain
    # versions and the library call
    del cache, logits, votes
    with torch.no_grad():
        k1 = [gemm_case(f"BitLinear long M={a[0].shape[0]}", *a)
              for (name, *_), (a, _) in seen.items()
              if name == "binary_gemm_hd"]
        k2 = [vote_case(f"CAM head long B={a[0].shape[0]}", *a)
              for (name, *_), (a, _) in seen.items() if name == "cam_vote"]
        require(any(a[0].shape[0] == s for (name, *_), (a, _) in seen.items()
                    if name == "binary_gemm_hd") and k2,
                f"long context: no operands captured: {list(seen)}")
        rows = {"binary_gemm_hd": lm_kernel_rows(card, "binary_gemm_hd", k1),
                "cam_vote": lm_kernel_rows(card, "cam_vote", k2)}
    del params, seen, k1, k2
    reset_peak(dev)

    # ---------- llama3.2-1b, 2 blocks, float32: card against the CPU
    cfg32 = dataclasses.replace(configs.get_config("llama3.2-1b" + smoke),
                                n_layers=2, dtype="float32")
    m32 = M.init_params(cfg32, gen, **here)
    cpu32 = M.CausalLM(cfg32, "cpu")
    cpu32.load_state_dict({k: v.cpu() for k, v in m32.state_dict().items()})
    toks = torch.randint(1, cfg32.vocab_size, (1, s_check + LONG_DECODE),
                         generator=gen, dtype=torch.int32, device=dev)
    worst = 0.0
    sides = []
    for model, tk in ((m32, toks), (cpu32, toks.cpu())):
        lg, c = steps.prefill_step(cfg32, model, {"tokens": tk[:, :s_check]},
                                   max_len=s_check + LONG_DECODE)
        out = [lg.cpu()]
        for i in range(LONG_DECODE):
            lg, c = steps.decode_step(cfg32, model, c,
                                      tk[:, s_check + i:s_check + i + 1],
                                      s_check + i)
            out.append(lg.cpu())
        sides.append(torch.stack(out))
    worst = float((sides[0] - sides[1]).abs().max())
    require(bool(torch.isfinite(sides[0]).all()) and bool(
        ((sides[0] - sides[1]).abs() <= LM_F32_ATOL
         + LM_F32_RTOL * sides[1].abs()).all()),
        f"long context f32 2 blocks: card != CPU (max {worst})")
    print(f"  llama3.2-1b, 2 blocks, float32, prefill {s_check} + "
          f"{LONG_DECODE} decode steps: card == CPU, max |dlogit| "
          f"{worst:.2e} (tol {LM_F32_ATOL} + {LM_F32_RTOL}|cpu|)")
    del m32, cpu32, sides
    reset_peak(dev)
    phase_s = time.perf_counter() - t_phase
    print(f"LM long-context phase: {phase_s:.1f} s")
    return dict(arch=cfg.name, batch=1, seq=s, decode_steps=LONG_DECODE,
                prefill_s=prefill_s, decode_ms=decode_ms,
                decode_ms_per_token=float(np.mean(decode_ms[1:] or
                                                  decode_ms)),
                max_memory_allocated_gb=peak,
                sxs_scores_one_layer_gb=scores_gb, attn_chunk=cfg.attn_chunk,
                launches=launches, launches_per_step=per_step,
                kernels=rows,
                f32_check=dict(seq=s_check, max_abs=worst,
                               atol=LM_F32_ATOL, rtol=LM_F32_RTOL),
                phase_s=phase_s, card=smi)


# ------------------------------------------------------- LM training (8)
# (a) the reference's 100M example: examples/lm_train.py --preset 100m
TRAIN_100M = ["--arch", "custom-100m", "--steps", "300", "--batch", "8",
              "--seq", "512", "--ckpt-every", "50", "--log-every", "50"]
# (b) the main path: llama3.2-1b+binary-ffn at full width and depth
TRAIN_MAIN = ["--arch", "llama3.2-1b+binary-ffn", "--steps", "10",
              "--batch", "8", "--seq", "256", "--log-every", "5"]
# (c) one step of llama3.2-1b, 2 blocks, float32 (TF32 off), card against
# CPU, at the peak rate (lr 3e-4, no warmup): float32 sums in another
# order; each leaf's gradients and m to 1e-4 of its largest, v (square in
# g) to 2e-4.  The first AdamW step moves a parameter by
# lr * (g / (|g| + eps) + wd * w), g clipped to norm 1: where |g| is near
# eps that ratio of two rounding-level numbers differs between the sides
# by up to ~0.2 (parameters 6.6e-5 apart, NVIDIA H100 80GB HBM3, 700 W),
# so the update is compared where the clipped |g| >= 1e3 * eps, to 1e-5,
# a thirtieth of lr: a skipped or doubled update differs there by ~lr.
TRAIN_CPU_LOSS_RTOL, TRAIN_CPU_GNORM_RTOL, TRAIN_CPU_PARAM_ATOL = \
    1e-5, 1e-4, 1e-5
TRAIN_CPU_G_FLOOR = 1e3  # x eps: the update is compared above it
# (e) examples/ft_demo.py: 40 steps, checkpoints every 10, failures at
# calls 13 and 27, a straggler (0.8 s more) at calls 31-35
FT_STEPS, FT_EVERY, FT_FAIL, FT_SLOW = 40, 10, (13, 27), range(31, 36)


def step_stats(step_s, tokens_per_step) -> dict:
    """ms a step and tokens/s over the steps after the first (the first
    loads the libraries and sizes the allocator), and the first's ms."""
    rest = step_s[1:] or step_s
    ms = float(np.mean(rest)) * 1e3
    return dict(steps=len(step_s), ms_per_step=ms, first_step_ms=step_s[0]
                * 1e3, steps_per_s=1e3 / ms,
                tokens_per_s=tokens_per_step * 1e3 / ms)


def peak_gb(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else None)


def reset_peak(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def step_split(out: dict, batch: int, seq: int) -> dict:
    """Where a trained state's step goes (three more updates of it): ms of
    `loss_and_grads` and of `apply_updates`, each on its own between
    synchronisations, then one `torch.profiler` pass over a whole
    `train_step` (device-kernel ms against the rest; the top kernels)."""
    from repro_torch.launch.train import make_batch_iter
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import loss_and_grads, train_step

    cfg, tcfg, state = out["cfg"], out["tcfg"], out["state"]
    b = next(make_batch_iter(cfg, batch, seq, 0))
    dev = state["params"].device
    sync(dev)
    t0 = time.perf_counter()
    _, grads, _ = loss_and_grads(cfg, tcfg, state["params"], b)
    sync(dev)
    t1 = time.perf_counter()
    O.apply_updates(tcfg.opt, state["params"], grads, state["opt"])
    sync(dev)
    t2 = time.perf_counter()
    del grads
    prof = profile_split(lambda: train_step(cfg, tcfg, state, b), iters=1)
    prof["kernels"] = dict(list(prof["kernels"].items())[:8])
    return dict(loss_and_grads_ms=(t1 - t0) * 1e3,
                apply_updates_ms=(t2 - t1) * 1e3, profile=prof)


def served_tokens_check(cfg, model, res, tol) -> dict:
    """The engine's tokens (phase 7's workload) against the same model:
    equal to the teacher-forced decode argmax everywhere, and to
    `forward`'s argmax where its top-2 margin exceeds 2 * tol; decode vs
    forward logits within tol.  Then `forward` as served (autograd off:
    every BitLinear projection on kernel 1, from the trained weights'
    packed signs) against the training form (autograd on: the float ±1
    product of the latent weights): the ±1 dot products are exact in
    both and scaled in the same order, so the logits must be bit-equal."""
    from repro_torch.models import model as M

    reqs = lm_requests(cfg, SEED + 22)
    worst, sure_n, sure_all, n_equal = 0.0, 0, 0, 0
    for i in range(0, LM_REQUESTS, LM_BATCH):
        with torch.no_grad():
            toks = torch.tensor([r.tokens for r in res[i:i + LM_BATCH]],
                                device=model.device)
            seq = torch.cat([torch.from_numpy(np.stack(
                [r.prompt for r in reqs[i:i + LM_BATCH]])).to(model.device),
                toks[:, :-1]], 1)
            tf, fw = decode_and_forward(cfg, model, seq)
        require(bool(torch.isfinite(tf).all()), f"{cfg.name}: decode "
                "logits not finite")
        require(torch.equal(tf.argmax(-1), toks),
                f"{cfg.name}: engine tokens != teacher-forced argmax")
        top2 = fw.topk(2, -1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
        require(torch.equal(fw.argmax(-1)[sure], toks[sure]),
                f"{cfg.name}: greedy tokens != forward's argmax where "
                f"the margin exceeds {2 * tol}")
        worst = max(worst, float((tf - fw).abs().max()))
        sure_n += int(sure.sum())
        sure_all += sure.numel()
        with torch.enable_grad():
            fw_train = M.forward(model, cfg, tokens=seq)[0][
                :, LM_PROMPT - 1:].detach()
        require(torch.equal(fw, fw_train), f"{cfg.name}: served forward "
                "(kernel 1) != the float ±1 training form, max |dlogit| "
                f"{float((fw - fw_train).abs().max()):.3e}")
        n_equal += fw.shape[0] * fw.shape[1]
        del fw_train
    require(worst <= tol, f"{cfg.name}: decode vs forward max |dlogit| "
            f"{worst:.4f} > {tol}")
    return dict(decode_vs_forward_max_abs=worst, tol=tol,
                tokens_checked_vs_forward=sure_n, tokens=sure_all,
                served_vs_train_form_equal_positions=n_equal)


def lm_train_phase(dev, smi: str, card, counted, quick: bool) -> dict:
    """Phase 8: LM training (`repro_torch.train`, `ft`, `launch.train`).

    With every launch count set to 0 just before the path: (a) the
    reference's 100M example, custom-100m (float32, 12 layers, d 768,
    V 32,000) for 300 steps of batch 8 x 512 tokens through
    `launch.train` with --ckpt-dir (the Supervisor, an async checkpoint
    every 50 steps); (b) llama3.2-1b+binary-ffn at full width and depth
    (bf16, remat full) for 10 steps of 8 x 256 through `launch.train`,
    then served through `Engine.generate` (phase 7's workload), which
    puts kernel 1 on the trained weights.  Kernel 1 must have launched;
    the training steps themselves launch no kernel (the BitLinear
    training form is the float ±1 product, as the reference's).  Then:
    kernel 1 == plain == library at the trained model's shapes; its
    tokens against teacher-forced decode and forward, and its served
    forward bit-equal to the training form; (c) one step of
    llama3.2-1b at 2 blocks in float32, card against CPU; (d) mixtral-
    8x7b (1 block) and falcon-mamba-7b (2 blocks) at full width, 3 steps
    each; (e) examples/ft_demo.py's scenario under the Supervisor with
    deterministic algorithms, final state == the failure-free run's; (f)
    EF-signSGD: 3 steps with compression, and `compress_with_feedback`
    card against CPU.  `quick` (a CPU rehearsal) takes `+smoke` configs
    and fewer steps."""
    import dataclasses
    import shutil

    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.ft import (Supervisor, SupervisorConfig, failing_step,
                                slow_step)
    from repro_torch.launch import train as launch
    from repro_torch.models import model as M
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train import grad_compress as G
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import loss_and_grads, make_train_step

    on_card = dev.type == "cuda"
    here = [] if on_card else ["--device", str(dev)]
    t_phase = time.perf_counter()
    ckpt_root = Path(__file__).resolve().parent / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    runs = {}

    def train_run(key, argv):
        if quick:  # a CPU rehearsal: smoke widths, a few short steps
            argv = [("llama3.2-1b+smoke" + ("+binary-ffn" if "binary" in a
                                             else "")) if a.startswith(
                ("custom", "llama")) else a for a in argv]
            for flag, val in (("--steps", "6"), ("--seq", "32"),
                              ("--ckpt-every", "3"), ("--log-every", "3")):
                if flag in argv:
                    argv[argv.index(flag) + 1] = val
        reset_peak(dev)
        t0 = time.perf_counter()
        out = launch.run(argv + here)
        wall = time.perf_counter() - t0
        a = launch.parse_args(argv)
        losses = out["losses"]
        require(all(np.isfinite(losses)), f"{key}: loss not finite")
        runs[key] = dict(
            arch=out["cfg"].name, dtype=out["cfg"].dtype,
            remat=out["cfg"].remat, batch=a.batch, seq=a.seq,
            params=sum(p.numel() for p in out["state"]["params"]
                       .parameters()),
            **step_stats(out["step_s"], a.batch * a.seq),
            wall_s=wall, peak_gb=peak_gb(dev), first_loss=losses[0],
            last_loss=losses[-1], losses=losses[::max(len(losses) // 30, 1)],
            ckpt_every=a.ckpt_every if a.ckpt_dir else None, card=smi)
        r = runs[key]
        print(f"  {key}: {r['arch']} {r['params'] / 1e6:.1f} M params, "
              f"{r['steps']} steps of {a.batch} x {a.seq}: "
              f"{r['ms_per_step']:.2f} ms a step ({r['steps_per_s']:.2f} "
              f"steps/s, {r['tokens_per_s']:.0f} tokens/s; first step "
              f"{r['first_step_ms']:.0f} ms), peak {r['peak_gb']} GB, loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {smi}")
        return out

    def split(key, out):  # after the run's checks: it updates the state
        sp = runs[key]["split"] = step_split(out, runs[key]["batch"],
                                             runs[key]["seq"])
        print(f"    {key}, a step apart: loss_and_grads "
              f"{sp['loss_and_grads_ms']:.1f} ms, apply_updates "
              f"{sp['apply_updates_ms']:.1f} ms; profiled step "
              f"{sp['profile']['call_ms']:.1f} ms, device kernels "
              f"{sp['profile']['device_kernel_ms']:.1f} ms")

    # --------------------------- the LM training path, counts from 0
    for fn in counted:
        fn.launches = 0
    out = train_run("a_custom_100m", TRAIN_100M + [
        "--ckpt-dir", str(ckpt_root / "a")])
    require(ckpt.latest_step(ckpt_root / "a") == (6 if quick else 300),
            "custom-100m: no checkpoint of the last step")
    tenth = max(len(out["losses"]) // 10, 1)  # the launcher's own verdict
    first, last = np.mean(out["losses"][:tenth]), np.mean(
        out["losses"][-tenth:])
    require(last < first or quick, f"custom-100m: loss {first:.4f} -> "
            f"{last:.4f} did not fall")
    split("a_custom_100m", out)
    del out
    out = train_run("b_llama3.2-1b+binary-ffn", list(TRAIN_MAIN))
    sync(dev)
    train_launches = {fn.__name__: fn.launches for fn in counted}
    model, cfg = out["state"]["params"], out["cfg"]
    res, serve = lm_engine_run(cfg, model, SEED + 22, dev, on_card)
    sync(dev)
    launches = {fn.__name__: fn.launches for fn in counted}
    print(f"LM training path: launches {launches} (the training steps "
          f"alone: {train_launches})")
    require(launches["binary_gemm_hd"] > 0 or not on_card,
            "binary_gemm_hd was not launched serving the trained model")
    require(not any(train_launches.values()),
            "a kernel launched inside the training steps")
    print(f"  served after training: prefill {serve['prefill_ms']:.2f} ms, "
          f"decode {serve['decode_ms_per_token']:.3f} ms/token, "
          f"{serve['tokens_per_s']:.1f} tokens/s; {smi}")

    # --------------- kernel 1 on the trained weights, the served tokens
    prompts = torch.from_numpy(np.stack(
        [r.prompt for r in lm_requests(cfg, SEED + 22)]))
    k1 = lm_kernel_rows(card, "binary_gemm_hd", bitlinear_cases(model,
                                                                prompts))
    served = served_tokens_check(cfg, model, res, LM_ATOL_BITLINEAR)
    print(f"  trained {cfg.name}: engine tokens == teacher-forced argmax; "
          f"== forward argmax at {served['tokens_checked_vs_forward']}/"
          f"{served['tokens']} positions past the margin; decode vs forward "
          f"max |dlogit| {served['decode_vs_forward_max_abs']:.4f} (tol "
          f"{LM_ATOL_BITLINEAR}); served forward (kernel 1) == the float "
          f"±1 training form, bit for bit, at "
          f"{served['served_vs_train_form_equal_positions']} positions")
    split("b_llama3.2-1b+binary-ffn", out)
    del out, model, res
    reset_peak(dev)

    def cut(name, **kw):  # full width; depth cut where asked
        return dataclasses.replace(
            configs.get_config(name + ("+smoke" if quick else "")), **kw)

    def data(cfg, b, s):
        return synthetic_stream(DataConfig(batch=b, seq_len=s,
                                           vocab_size=cfg.vocab_size))

    dev_kw = {} if on_card else {"device": dev}
    gen = torch.Generator(dev).manual_seed(SEED + 31)

    # ------------------------------ (c) one step, card against the CPU
    cfg32 = cut("llama3.2-1b", n_layers=2, dtype="float32")
    tcfg = TrainConfig(opt=O.OptimizerConfig(warmup_steps=0))  # lr 3e-4
    card_state = init_train_state(cfg32, tcfg, gen, **dev_kw)
    cpu_model = M.CausalLM(cfg32, "cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               card_state["params"].state_dict().items()})
    cpu_state = {"params": cpu_model,
                 "opt": O.init_opt_state(tcfg.opt, cpu_model)}
    before = {k: p.detach().cpu().clone() for k, p in
              cpu_model.named_parameters()}
    batch = next(data(cfg32, 2, 64))
    step = {}  # train_step's body, each side's gradients kept
    for side, st in (("card", card_state), ("cpu", cpu_state)):
        loss, grads, _ = loss_and_grads(cfg32, tcfg, st["params"], batch)
        _, _, om = O.apply_updates(tcfg.opt, st["params"], grads, st["opt"])
        step[side] = (float(loss), grads, float(om["grad_norm"]))
    (loss, grads, gnorm), (loss_cpu, grads_cpu, gnorm_cpu) = \
        step["card"], step["cpu"]
    loss_rel = abs(loss / loss_cpu - 1)
    gnorm_rel = abs(gnorm / gnorm_cpu - 1)

    def rel(card_tree, cpu_tree):  # max |d| / max |cpu| of each leaf
        return {k: float((t.cpu() - cpu_tree[k]).abs().max()
                         / cpu_tree[k].abs().max().clamp_min(1e-30))
                for k, t in card_tree.items()}

    grad_rel = rel(grads, grads_cpu)
    m_rel = rel(card_state["opt"]["m"], cpu_state["opt"]["m"])
    v_rel = rel(card_state["opt"]["v"], cpu_state["opt"]["v"])
    lr = float(O.schedule(tcfg.opt, torch.ones((), dtype=torch.int32)))
    g_floor = TRAIN_CPU_G_FLOOR * tcfg.opt.eps
    param_err, n_cmp, n_all = {}, 0, 0
    for k, p in card_state["params"].named_parameters():
        # the clipped gradient Adam saw: m = (1 - b1) * g at step 1
        g_hat = cpu_state["opt"]["m"][k].abs() / (1 - tcfg.opt.b1)
        sure = g_hat >= g_floor
        d_card = p.detach().cpu() - before[k]
        d_cpu = cpu_model.get_parameter(k).detach() - before[k]
        param_err[k] = float((d_card - d_cpu)[sure].abs().max()) if bool(
            sure.any()) else 0.0
        n_cmp += int(sure.sum())
        n_all += sure.numel()
    worst_g, worst_m, worst_v, worst_p = (max(d, key=d.get) for d in (
        grad_rel, m_rel, v_rel, param_err))
    require(loss_rel <= TRAIN_CPU_LOSS_RTOL, f"train step card vs CPU: loss "
            f"rel {loss_rel:.2e} > {TRAIN_CPU_LOSS_RTOL}")
    require(gnorm_rel <= TRAIN_CPU_GNORM_RTOL, f"train step card vs CPU: "
            f"grad norm rel {gnorm_rel:.2e} > {TRAIN_CPU_GNORM_RTOL}")
    for what, d, worst, tol in (("gradient", grad_rel, worst_g, 1),
                                ("m", m_rel, worst_m, 1),
                                ("v", v_rel, worst_v, 2)):
        require(d[worst] <= tol * TRAIN_CPU_GNORM_RTOL, f"train step card "
                f"vs CPU: {worst} {what} max |d| / max |cpu| {d[worst]:.2e}"
                f" > {tol * TRAIN_CPU_GNORM_RTOL}")
    require(n_cmp > 0, "train step card vs CPU: no element's |g| reaches "
            f"{g_floor:.0e}")
    require(param_err[worst_p] <= TRAIN_CPU_PARAM_ATOL, f"train step card vs "
            f"CPU: {worst_p} update max |d| {param_err[worst_p]:.2e} > "
            f"{TRAIN_CPU_PARAM_ATOL} (lr {lr:.1e})")
    card_vs_cpu = dict(loss_rel=loss_rel, grad_norm_rel=gnorm_rel,
                       grad_max_rel=grad_rel[worst_g], grad_worst=worst_g,
                       m_max_rel=m_rel[worst_m], v_max_rel=v_rel[worst_v],
                       update_max_abs=param_err[worst_p],
                       update_worst=worst_p, update_elements=n_cmp,
                       elements=n_all, loss=loss, grad_norm=gnorm, lr=lr)
    print(f"  llama3.2-1b, 2 blocks, float32, one step card vs CPU: loss "
          f"rel {loss_rel:.2e}, grad norm rel {gnorm_rel:.2e}, max |d| / "
          f"max |cpu|: gradients {grad_rel[worst_g]:.2e} ({worst_g}), m "
          f"{m_rel[worst_m]:.2e}, v {v_rel[worst_v]:.2e}; update max |d| "
          f"{param_err[worst_p]:.2e} ({worst_p}; lr {lr:.1e}) at "
          f"{n_cmp}/{n_all} elements where |g| >= {g_floor:.0e} (tols "
          f"{TRAIN_CPU_LOSS_RTOL}, {TRAIN_CPU_GNORM_RTOL}, "
          f"{TRAIN_CPU_GNORM_RTOL} (v {2 * TRAIN_CPU_GNORM_RTOL}), "
          f"{TRAIN_CPU_PARAM_ATOL})")

    # ------------- (f) EF-signSGD on the same model: feedback, the hook
    res0 = G.init_residual(card_state["params"])
    hat, res1 = G.compress_with_feedback(grads, res0)
    hat_cpu, res_cpu = G.compress_with_feedback(
        {k: g.cpu() for k, g in grads.items()},
        {k: r.cpu() for k, r in res0.items()})
    for k in hat:
        require(torch.equal(torch.sign(hat[k].cpu()), torch.sign(
            hat_cpu[k])), f"EF-signSGD {k}: card bits != CPU bits")
        require(torch.allclose(hat[k].cpu(), hat_cpu[k], rtol=1e-5,
                               atol=0) and torch.allclose(
            res1[k].cpu(), res_cpu[k], rtol=1e-5, atol=1e-9),
            f"EF-signSGD {k}: card scale / residual != CPU")
    del cpu_state, cpu_model, before, step, grads, grads_cpu, hat, res0, \
        res1, hat_cpu, res_cpu
    ccfg = dataclasses.replace(tcfg, compression=G.CompressionConfig(
        enabled=True))
    it = data(cfg32, 2, 64)
    comp_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        card_state, m = make_train_step(cfg32, ccfg)(card_state, next(it))
        require(bool(torch.isfinite(m["loss"])) and float(m["compressed"])
                == 1.0, "compressed train step: loss not finite or "
                "compression off")
        sync(dev)
        comp_s.append(time.perf_counter() - t0)
    ef = dict(**step_stats(comp_s, 2 * 64), loss=float(m["loss"]),
              compression_ratio=G.compression_ratio(card_state["params"]))
    print(f"  EF-signSGD: compress_with_feedback card == CPU (bits; scale "
          f"and residual to 1e-5); 3 compressed steps, "
          f"{ef['ms_per_step']:.1f} ms a step; wire ratio "
          f"{ef['compression_ratio']:.1f}x")
    del card_state
    reset_peak(dev)

    # ------------------------------- (d) MoE and Mamba at full width
    wide = {}
    for key, c, b, s in (
            ("mixtral-8x7b/1", cut("mixtral-8x7b", n_layers=1), 4, 128),
            # S = 512: two chunks of the Mamba scan, each rematerialised
            ("falcon-mamba-7b/2", cut("falcon-mamba-7b", n_layers=2), 4,
             512)):
        reset_peak(dev)
        st = init_train_state(c, TrainConfig(), gen, **dev_kw)
        fn, it = make_train_step(c, TrainConfig()), data(c, b, s)
        times, ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            st, m = fn(st, next(it))
            ms.append({k: float(v) for k, v in m.items()})
            times.append(time.perf_counter() - t0)
        require(all(np.isfinite(x["loss"]) for x in ms), f"{key}: loss not "
                "finite")
        require((ms[-1]["moe_aux"] > 0) == (c.n_experts > 0),
                f"{key}: moe_aux {ms[-1]['moe_aux']}")
        wide[key] = dict(params=sum(p.numel() for p in st["params"]
                                    .parameters()),
                         **step_stats(times, b * s), peak_gb=peak_gb(dev),
                         losses=[x["loss"] for x in ms],
                         moe_aux=ms[-1]["moe_aux"], batch=b, seq=s)
        w = wide[key]
        print(f"  {key}: {w['params'] / 1e9:.2f} B params, 3 steps of {b} x "
              f"{s}: {w['ms_per_step']:.1f} ms a step, peak {w['peak_gb']} "
              f"GB, losses {[round(x, 4) for x in w['losses']]}, moe_aux "
              f"{w['moe_aux']:.4f}; {smi}")
        del st, fn
    reset_peak(dev)

    # ------------------ (e) examples/ft_demo.py's scenario on the card
    ft_cfg = configs.get_config("llama3.2-1b+smoke")
    ft_tcfg = TrainConfig()

    def ft_run(tag, faulty):
        state = init_train_state(ft_cfg, ft_tcfg, torch.Generator(
            dev).manual_seed(SEED + 41), **dev_kw)
        step = make_train_step(ft_cfg, ft_tcfg)
        if faulty:
            step = slow_step(failing_step(step, FT_FAIL), FT_SLOW, 0.8)
        alerts = []

        def make_data(start):
            it = data(ft_cfg, 4, 32)
            for _ in range(start):
                next(it)
            return it

        sup = Supervisor(SupervisorConfig(
            ckpt_dir=ckpt_root / f"e_{tag}", ckpt_every=FT_EVERY,
            backoff_s=0.0, straggler_z=3.0, straggler_patience=2),
            step, make_data, state, on_straggler=alerts.append)
        return sup, sup.run(state, FT_STEPS), alerts

    torch.use_deterministic_algorithms(True)
    try:
        _, clean, _ = ft_run("clean", False)
        sup, faulted, alerts = ft_run("flaky", True)
    finally:
        torch.use_deterministic_algorithms(False)
    equal = all(torch.equal(x, y) for (_, x), (_, y) in zip(
        ckpt.leaf_paths(clean), ckpt.leaf_paths(faulted)))
    require(equal, "ft demo: final state != the failure-free run's")
    require(sup.restarts == len(FT_FAIL), f"ft demo: {sup.restarts} "
            "restarts")
    require(bool(alerts), "ft demo: the straggler raised no alert")
    ft = dict(restarts=sup.restarts, straggler_alerts=len(alerts),
              alerts=alerts, steps_run=len(sup.history),
              final_loss=sup.history[-1]["loss"], equal_to_clean=equal)
    print(f"  ft demo: {sup.restarts} restarts, {len(alerts)} straggler "
          f"alerts (steps {[a['step'] for a in alerts]}, "
          f"{[round(a['dt'], 3) for a in alerts]} s against means "
          f"{[round(a['mean'], 4) for a in alerts]} s), {len(sup.history)} "
          "steps run; final state == failure-free run's (deterministic "
          "algorithms)")
    del clean, faulted
    shutil.rmtree(ckpt_root, ignore_errors=True)
    reset_peak(dev)
    phase_s = time.perf_counter() - t_phase
    print(f"LM training phase: {phase_s:.1f} s")
    return dict(launches=launches, train_step_launches=train_launches,
                runs=runs, served_after_training=dict(**serve, **served),
                kernels=dict(binary_gemm_hd=k1), card_vs_cpu=card_vs_cpu,
                ef_signsgd=ef, wide=wide, ft_demo=ft, phase_s=phase_s,
                card=smi)


# ----------------------------------------------------- the mesh path (9)
# the sharded LM serving workload: phase 7's, through the serving launcher
# (8 requests of 16 prompt tokens, 16 new, batches of 4); each timed run
# after an untimed one of the same launcher
MESH_SERVE = ["--cam-head", "--requests", str(LM_REQUESTS), "--prompt-len",
              str(LM_PROMPT), "--max-new", str(LM_NEW), "--batch",
              str(LM_BATCH)]
# the sharded train step: llama3.2-1b, full width, 2 blocks, float32 (TF32
# off; the launcher is handed the cut config), batch 2 x 64, lr 3e-4 with
# no warmup as in phase 8(c), so a skipped or doubled update differs by
# ~lr, thirty times TRAIN_CPU_PARAM_ATOL; one step compared, four timed
# (the first loads the libraries)
MESH_TRAIN = ["--batch", "2", "--seq", "64", "--log-every", "1000"]


def mesh_phase(dev, smi: str, card, counted, served_models: dict,
               served_rr: dict, quick: bool) -> dict:
    """Phase 9: the sharding layer on one card, a (1, 1) mesh.

    (a) The four paper classifiers in `PicBnnServer(fanout="spmd")`,
    once over the card's devices (one) and once over two slices of the
    one card ([dev, dev]: each bucket split in two, each half on its own
    stream, gathered on the first), 400 requests a model each; the
    counts set to 0 just before, kernels 3 and 4 required.  Predictions
    and votes equal phase 3's round-robin server and a direct `run`, and
    every result carries device -1.  Then the two slices under load:
    each model's whole input in bursts of 1-39, each equal to a direct
    `run`.
    (b) `launch.serve --model-parallel 1` on llama3.2-1b+binary-ffn with
    the CAM head at full width and depth (DTensor parameters under
    SERVE_RULES, one NCCL rank), the counts set to 0 just before it:
    kernels 1 (the BitLinear FFN) and 2 (the CAM head) must launch on the
    local shards; its tokens equal the same launcher's without a mesh on
    the same weights (phase 7's unsharded Engine); kernel 1 at the
    path's prefill and decode shapes and kernel 2 at its head, on the
    packed rows the sharded path made, equal to their plain versions.
    (c) `launch.train --model-parallel 1` on llama3.2-1b at 2 blocks,
    float32, lr 3e-4 with no warmup: the state after one step against
    the launcher's without a mesh, within phase 8's tolerances (loss,
    each m and v leaf, the update where |g| >= 1e3 * eps to lr / 30).
    Decode ms a token and train ms a step, sharded against unsharded,
    are the DTensor layer's cost on one card.  `quick` (a CPU
    rehearsal) takes the `+smoke` configs and a gloo rank."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models import binary_lm
    from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer
    from repro_torch.sharding.rules import is_dtensor
    from repro_torch.spec import InferenceSpec
    from repro_torch.train.optimizer import OptimizerConfig, schedule

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    smoke = "+smoke" if quick else ""
    dev_args = [] if on_card else ["--device", str(dev)]
    launches = {}

    def zero():
        for fn in counted:
            fn.launches = 0

    def counts():
        sync(dev)
        return {fn.__name__: fn.launches for fn in counted}

    # ------------------------------ (a) classifiers, fanout="spmd"
    layouts = {"card": None if on_card else [dev], "2 slices": [dev, dev]}
    policy = BatchingPolicy(max_batch=256, max_wait_us=500)
    spmd, rates = {}, {}
    zero()
    for label, devices in layouts.items():
        server = PicBnnServer(policy, devices=devices, fanout="spmd")
        for mid, m in served_models.items():
            server.register(mid, m["gpu"])
        server.warmup()
        with server:
            singles = {mid: [server.submit(mid, m["x"][i])
                             for i in range(100)]
                       for mid, m in served_models.items()}
            bursts = {mid: server.submit_many(mid, m["x"][100:400])
                      for mid, m in served_models.items()}
            for mid in served_models:
                res = [h.result(timeout=60) for h in singles[mid]]
                spmd[(label, mid)] = (
                    np.concatenate([np.stack([r.votes for r in res]),
                                    bursts[mid].votes_all(timeout=60)]),
                    np.concatenate([[r.pred for r in res],
                                    bursts[mid].wait_all(timeout=60)]),
                    {r.device for r in res})
        rates[label] = {mid: ms.inf_per_s for mid, ms in
                        server.stats().per_model.items()}
    launches["spmd"] = counts()
    print(f"mesh path (a) fanout=spmd: launches {launches['spmd']}")
    for name in ("fused_mlp_votes", "fused_conv_votes"):
        require(launches["spmd"][name] > 0 or not on_card,
                f"{name} was not launched under fanout='spmd'")
    for (label, mid), (votes, preds, devs) in spmd.items():
        direct = served_models[mid]["gpu"].run(
            served_models[mid]["x"][:400], InferenceSpec()).cpu().numpy()
        require(np.array_equal(votes, direct),
                f"spmd {label} {mid}: votes != direct run")
        require(np.array_equal(votes, served_rr[mid]),
                f"spmd {label} {mid}: votes != round-robin")
        require(np.array_equal(preds, direct.argmax(-1)),
                f"spmd {label} {mid}: predictions != direct argmax")
        require(devs == {-1}, f"spmd {label} {mid}: result devices {devs}")
    print(f"  spmd ({', '.join(layouts)}): 4 models x 400 requests == "
          f"round-robin == direct run, device -1 on every result")
    # the two-slice gather under load: each model's whole input in bursts
    # of 1-39 requests, submitted back to back so batches stay in flight,
    # each burst equal to a direct run
    server = PicBnnServer(policy, devices=[dev, dev], fanout="spmd")
    for mid, m in served_models.items():
        server.register(mid, m["gpu"])
    server.warmup()
    n_x = min(len(m["x"]) for m in served_models.values())
    cuts = np.cumsum(np.random.default_rng(SEED + 43).integers(1, 40, n_x))
    cuts = np.r_[0, cuts[cuts < n_x], n_x]
    with server:
        stress = [(mid, lo, hi, server.submit_many(mid, m["x"][lo:hi]))
                  for lo, hi in zip(cuts[:-1], cuts[1:])
                  for mid, m in served_models.items()]
        got = {mid: np.concatenate([h.votes_all(timeout=120)
                                    for m2, _, _, h in stress if m2 == mid])
               for mid in served_models}
    for mid, m in served_models.items():
        direct = m["gpu"].run(m["x"][:n_x], InferenceSpec()).cpu().numpy()
        require(np.array_equal(got[mid], direct),
                f"spmd 2 slices {mid}: {len(cuts) - 1} bursts != direct run")
    print(f"  spmd 2 slices under load: 4 models x {len(cuts) - 1} bursts "
          f"({n_x} requests each) == direct run")

    # one rank for the whole phase; each launcher finds it and leaves it
    lmesh.ensure_process_group(dev.type)
    try:
        # ---------------------- (b) LM serving, --model-parallel 1
        sv = ["--arch", "llama3.2-1b+binary-ffn" + smoke] + MESH_SERVE \
            + dev_args
        mp = ["--model-parallel", "1"]
        lserve.run(sv)  # warm: kernel loads, the allocator's pools
        plain = lserve.run(sv)
        require(dist.is_initialized(), "the serving launcher destroyed the "
                "caller's process group")
        lserve.run(sv + mp)  # warm: DTensor's sharding-propagation caches
        sync(dev)
        zero()
        sharded = lserve.run(sv + mp)
        launches["lm_serve"] = counts()
        print(f"mesh path (b) launch.serve --model-parallel 1: launches "
              f"{launches['lm_serve']}")
        for name in ("binary_gemm_hd", "cam_vote"):
            require(launches["lm_serve"][name] > 0 or not on_card,
                    f"{name} was not launched on the sharded LM path")
        params, cfg = sharded["params"], sharded["cfg"]
        require(is_dtensor(params.embed) and is_dtensor(
            params.blocks[0].sub0.ffn.w_gate), "parameters are not DTensors")
        toks = [r.tokens for r in sharded["results"]]
        require(toks == [r.tokens for r in plain["results"]],
                "sharded engine tokens != unsharded")

        def serve_perf(out):
            heads = out["results"][::LM_BATCH]
            return dict(prefill_ms=float(np.mean([r.prefill_ms
                                                  for r in heads])),
                        decode_ms_per_token=float(np.mean(
                            [r.decode_ms / (LM_NEW - 1) for r in heads])),
                        tokens_per_s=sum(len(r.tokens) for r in
                                         out["results"]) / out["wall_s"])

        perf = {"serve_unsharded": serve_perf(plain),
                "serve_mesh_1x1": serve_perf(sharded)}
        # the kernels on the packed local rows the sharded path made
        ffn = params.blocks[0].sub0.ffn

        def packed(owner, prefix):
            return next(v[1] for k, v in owner.__dict__["_packed"].items()
                        if k.startswith(prefix + "@"))

        rng = np.random.default_rng(0)  # the launcher's prompts
        prompts = torch.from_numpy(np.stack([
            rng.integers(1, cfg.vocab_size, LM_PROMPT).astype(np.int32)
            for _ in range(LM_REQUESTS)]))
        gen = torch.Generator(dev).manual_seed(SEED + 41)
        with torch.no_grad():
            x = params.embed.to_local()[prompts[:LM_BATCH].to(dev)].reshape(
                -1, cfg.d_model)
            act = torch.randn((LM_BATCH, cfg.d_ff), generator=gen,
                              device=dev).to(x.dtype)
            h = torch.randn((LM_BATCH, cfg.d_model), generator=gen,
                            device=dev)
            k1 = [gemm_case("mesh BitLinear prefill w_gate",
                            binary_lm.sign_bits(x), packed(ffn, "w_gate")[0]),
                  gemm_case("mesh BitLinear decode w_down",
                            binary_lm.sign_bits(act),
                            packed(ffn, "w_down")[0])]
            k2 = [vote_case("mesh CAM head llama3.2-1b",
                            binary_lm.sign_bits(h),
                            packed(params.cam_head, "rows"),
                            params.cam_head.thresholds.to_local())]
            rows = {"binary_gemm_hd": lm_kernel_rows(card, "binary_gemm_hd",
                                                     k1),
                    "cam_vote": lm_kernel_rows(card, "cam_vote", k2)}
        del plain, sharded, params, ffn, k1, k2, x, act, h
        gc.collect()

        # ---------------------- (c) LM training, --model-parallel 1
        tr = ["--arch", "llama3.2-1b" + smoke] + MESH_TRAIN + dev_args
        cfg32 = dataclasses.replace(
            configs.get_config("llama3.2-1b" + smoke), n_layers=2,
            dtype="float32")
        ocfg = OptimizerConfig(warmup_steps=0)  # lr 3e-4 from the first step
        one = [ltrain.run(tr + ["--steps", "1"] + mp, cfg=cfg32, opt=ocfg)
               for mp in ([], ["--model-parallel", "1"])]
        (s0, l0), (s1, l1) = ((o["state"], o["losses"][0]) for o in one)
        lr = float(schedule(ocfg, torch.zeros((), dtype=torch.int32)))
        require(abs(lr / ocfg.lr - 1) < 1e-6,
                f"mesh train step: first-step lr {lr}")

        def whole(t):
            return (t.full_tensor() if is_dtensor(t) else t).detach()

        loss_rel = abs(l1 / l0 - 1)
        rel = {}
        for what in ("m", "v"):
            rel[what] = max(
                float((whole(s1["opt"][what][k]) - v).abs().max()
                      / v.abs().max().clamp_min(1e-30))
                for k, v in s0["opt"][what].items())
        opt = s0["opt"]
        g_floor = TRAIN_CPU_G_FLOOR * ocfg.eps
        upd, n_cmp = 0.0, 0
        p1 = dict(s1["params"].named_parameters())
        for k, p in s0["params"].named_parameters():
            # the clipped gradient Adam saw: m = (1 - b1) * g at step 1
            sure = opt["m"][k].abs() / (1 - ocfg.b1) >= g_floor
            if bool(sure.any()):
                upd = max(upd, float((whole(p1[k]) - p.detach())[sure]
                                     .abs().max()))
                n_cmp += int(sure.sum())
        require(loss_rel <= TRAIN_CPU_LOSS_RTOL,
                f"mesh train step: loss rel {loss_rel:.2e}")
        require(rel["m"] <= TRAIN_CPU_GNORM_RTOL and
                rel["v"] <= 2 * TRAIN_CPU_GNORM_RTOL,
                f"mesh train step: m / v max rel {rel}")
        require(n_cmp > 0 and upd <= TRAIN_CPU_PARAM_ATOL,
                f"mesh train step: update max |d| {upd:.2e} at {n_cmp} "
                f"(lr {lr:.1e})")
        del one, s0, s1, p1, opt
        gc.collect()
        timed = {}
        for label, mp in (("train_unsharded", []),
                          ("train_mesh_1x1", ["--model-parallel", "1"])):
            out = ltrain.run(tr + ["--steps", "4"] + mp, cfg=cfg32, opt=ocfg)
            timed[label] = step_stats(out["step_s"], 2 * 64)
            del out
            gc.collect()
        perf.update(timed)
        require(dist.is_initialized(), "the train launcher destroyed the "
                "caller's process group")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if on_card:
        torch.cuda.empty_cache()
    for key, p in perf.items():
        print(f"  {key:18s} " + ", ".join(
            f"{k} {v:.3f}" for k, v in p.items()
            if k in ("prefill_ms", "decode_ms_per_token", "ms_per_step",
                     "tokens_per_s")) + f" ({smi})")
    dt_cost = dict(
        decode_ms_per_token=(perf["serve_mesh_1x1"]["decode_ms_per_token"],
                             perf["serve_unsharded"]["decode_ms_per_token"]),
        train_ms_per_step=(perf["train_mesh_1x1"]["ms_per_step"],
                           perf["train_unsharded"]["ms_per_step"]))
    print(f"  DTensor cost on one card (mesh 1x1 vs none): decode "
          f"{dt_cost['decode_ms_per_token'][0]:.3f} vs "
          f"{dt_cost['decode_ms_per_token'][1]:.3f} ms/token, train "
          f"{dt_cost['train_ms_per_step'][0]:.1f} vs "
          f"{dt_cost['train_ms_per_step'][1]:.1f} ms/step ({smi})")
    print(f"  mesh train step == unsharded: loss rel {loss_rel:.2e}, m "
          f"{rel['m']:.2e}, v {rel['v']:.2e}, update max |d| {upd:.2e} at "
          f"{n_cmp} elements; sharded tokens == unsharded")
    phase_s = time.perf_counter() - t_phase
    print(f"mesh phase: {phase_s:.1f} s")
    return dict(launches=launches, perf=perf, dtensor_cost=dt_cost,
                kernels=rows, spmd_inf_per_s=rates,
                train_step=dict(loss_rel=loss_rel, m_max_rel=rel["m"],
                                v_max_rel=rel["v"], update_max_abs=upd,
                                update_elements=n_cmp),
                phase_s=phase_s, card=smi)


# ------------------------------------------------------ the dry-run (10)
# (a) full-size cells on the fake production meshes: each
# `python -m repro_torch.launch.dryrun` call a subprocess of its own (a
# fake default group cannot share a process with a real one), all three
# started together
DRY_RUNS = (["--arch", "llama3.2-1b", "--shape",
             "train_4k,prefill_32k,decode_32k"],
            ["--arch", "mixtral-8x7b", "--shape", "decode_32k",
             "--multi-pod"],
            ["--arch", "llama3.2-1b+binary-ffn+cam-head", "--shape",
             "decode_32k"])
DRY_CELLS = ("llama3.2-1b__train_4k__pod", "llama3.2-1b__prefill_32k__pod",
             "llama3.2-1b__decode_32k__pod", "mixtral-8x7b__decode_32k__multipod",
             "llama3.2-1b+binary-ffn+cam-head__decode_32k__pod")
# (b) two of phase 9's (1, 1)-mesh runs, counted on the card and traced on
# a fake (1, 1) group: phase 9's served model decoding one step at B = 4
# over an 80-slot cache (prompt 16 + the 64 slots prefill adds), and its
# train step (llama3.2-1b, 2 blocks, float32, 2 x 64, lr 3e-4 from the
# first step).  Both from fresh weights, so each packs its weight rows
# inside the step, as the dry-run's fakes do.
DRY_DECODE = dict(label="decode", arch="llama3.2-1b+binary-ffn+cam-head",
                  cut={}, shape=("decode_b4", "decode", LM_PROMPT + 64,
                                 LM_BATCH))
DRY_TRAIN = dict(label="train", arch="llama3.2-1b",
                 cut={"n_layers": 2, "dtype": "float32"},
                 shape=("train_2x64", "train", 64, 2))
# and a Mamba train step over two scan chunks (falcon-mamba-7b, 2 blocks,
# float32, 2 x 512): the fake trace runs one chunk and charges it twice,
# the card runs both
DRY_MAMBA = dict(label="mamba_train", arch="falcon-mamba-7b",
                 cut={"n_layers": 2, "dtype": "float32"},
                 shape=("train_2x512", "train", 512, 2))
# peak_estimate_gib against torch.cuda.max_memory_allocated (above what
# was allocated before the step's arguments): the estimate counts each
# storage's bytes, the allocator rounds each block up to 512 bytes and
# holds cuBLAS's workspace beside the step; both are a few MiB against
# the GiBs of these steps
DRY_PEAK_RTOL = 0.05
_FAKE_COUNTS = """
import dataclasses, json, sys
sys.path.insert(0, "src")
from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.train import TrainConfig
from repro_torch.train.optimizer import OptimizerConfig

out = {}
with dryrun.fake_group(1):
    mesh = dryrun.fake_mesh((1, 1), ("data", "model"))
    for c in json.loads(sys.argv[1]):
        cfg = dataclasses.replace(configs.get_config(c["arch"]), **c["cut"])
        shape = ShapeConfig(*c["shape"])
        tcfg = (TrainConfig(opt=OptimizerConfig(warmup_steps=0))
                if shape.kind == "train" else None)
        rec = dryrun.measure(cfg, shape, mesh, tcfg=tcfg)
        rec.pop("ops")
        out[c["label"]] = rec
print("DRY-COUNTS " + json.dumps(out, default=str))
"""


def real_counts(cell: dict, dev, mesh, counted) -> dict:
    """Cell (b) run for real on `dev` on a (1, 1) mesh, counted by the
    dry-run's counter: the totals, the step's arguments (bytes of their
    storages, as the dry-run counts them, and as allocated), the peak
    allocated above what was there before them, the kernels' launches in
    the step, and under "step" the step itself (for `warm_step_ms`)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.ft import reshard_state, state_shardings
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.serve.steps import decode_step
    from repro_torch.sharding import SERVE_RULES, TRAIN_RULES, use_rules
    from repro_torch.train import TrainConfig, init_train_state, train_step
    from repro_torch.train.optimizer import OptimizerConfig

    on_card = dev.type == "cuda"
    cfg = dataclasses.replace(configs.get_config(cell["arch"]), **cell["cut"])
    shape = ShapeConfig(*cell["shape"])
    b, s = shape.global_batch, shape.seq_len
    gen = torch.Generator(dev).manual_seed(SEED + 51)
    sync(dev)
    base = torch.cuda.memory_allocated(dev) if on_card else 0
    if shape.kind == "decode":
        rules = SERVE_RULES.resolve(mesh)
        params = M.init_params(cfg, gen, dev)
        M.shard_params(params, mesh, rules)
        with use_rules(rules, mesh):
            cache = M.init_cache(cfg, b, s, dev)
        tokens = torch.randint(1, cfg.vocab_size, (b, 1), generator=gen,
                               dtype=torch.int32, device=dev)
        pos = torch.tensor(s - 1, dtype=torch.int32, device=dev)
        args = (params, cache, tokens, pos)

        def step():
            return decode_step(cfg, params, cache, tokens, s - 1)
    else:
        rules = TRAIN_RULES.resolve(mesh)
        tcfg = TrainConfig(opt=OptimizerConfig(warmup_steps=0))
        state = init_train_state(cfg, tcfg, gen, dev)
        state = reshard_state(state, state_shardings(cfg, mesh, rules,
                                                     state))
        batch = {k: torch.randint(1, cfg.vocab_size, (b, s), generator=gen,
                                  dtype=torch.int32, device=dev)
                 for k in ("tokens", "labels")}
        args = (state, batch)

        def step():
            return train_step(cfg, tcfg, state, batch)
    sync(dev)
    allocated = (torch.cuda.memory_allocated(dev) - base) if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for fn in counted:
        fn.launches = 0
    with use_rules(rules, mesh), dryrun.instruments() as (counter, _, _):
        step()
    sync(dev)
    launches = {fn.__name__: fn.launches for fn in counted}
    peak = (torch.cuda.max_memory_allocated(dev) - base) if on_card else None
    t = counter.totals

    def ruled_step():
        with use_rules(rules, mesh):
            step()

    out = dict(flops=t.flops, binary_ops=t.binary_ops, hbm_bytes=t.hbm_bytes,
               collective_count=t.collective_count,
               argument_bytes=sum(dryrun.local_bytes(args).values()),
               argument_allocated=allocated, peak_allocated=peak,
               launches=launches, step=ruled_step)
    if shape.kind == "decode":
        out["params"] = params
    return out


def warm_step_ms(step, dev) -> float:
    """Mean wall ms of three more runs of a `real_counts` step."""
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        sync(dev)
        warm.append(time.perf_counter() - t0)
    return float(np.mean(warm)) * 1e3


def dryrun_phase(dev, smi: str, counted, quick: bool) -> dict:
    """Phase 10: the dry-run tooling (`repro_torch.launch.dryrun`).

    (a) Full-size cells on the fake production meshes, each dry-run call
    a subprocess: llama3.2-1b train_4k, prefill_32k and decode_32k on the
    16 x 16 pod mesh, mixtral-8x7b decode_32k on the 2 x 16 x 16
    multi-pod mesh, and llama3.2-1b+binary-ffn+cam-head decode_32k, which
    puts kernels 1 and 2 through their fake forms; each must be "ok"
    (the Mamba cells trace in `scripts/torch_dryrun_sweep.py` only: one
    takes over a minute, and (b)'s Mamba step holds the trip rule on the
    card).  Printed per cell: peak GiB a device, the bottleneck, the
    three terms and the trace's seconds.
    (b) Two of phase 9's runs on a (1, 1) mesh, and a Mamba train step of
    two scan chunks (falcon-mamba-7b, 2 blocks, float32, 2 x 512), run on
    the card under the dry-run's cost counter (one NCCL rank), against
    the same cells traced on a fake (1, 1) group in a subprocess (one
    scan chunk run, charged twice): FLOPs, binary operations, HBM
    bytes and collective count equal; argument bytes equal the state's
    bytes; peak_estimate_gib within DRY_PEAK_RTOL of
    `torch.cuda.max_memory_allocated`; the roofline's step_time_lb_s as a
    fraction of a warm step's time.  The counts set to 0 just before the
    decode step: kernels 1 and 2 must launch in it, through their custom
    ops, and equal their plain versions on the rows it packed.  `quick`
    (a CPU rehearsal) takes the `+smoke` configs for (b) and a gloo rank.
    """
    import torch.distributed as dist

    from repro_torch.kernels import binary_gemm, cam_search
    from repro_torch.launch import mesh as lmesh

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "dryrun_smoke"
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    smoke = "+smoke" if quick else ""
    cells_b = [dict(c, arch=c["arch"] + smoke) for c in (DRY_DECODE,
                                                          DRY_TRAIN,
                                                          DRY_MAMBA)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *a, "--out",
         str(out_dir)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for a in DRY_RUNS]
    fake = subprocess.Popen(
        [sys.executable, "-c", _FAKE_COUNTS, json.dumps(cells_b)], cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # ------------------------- (b) the real side, while those run
        lmesh.ensure_process_group(dev.type)
        try:
            mesh = lmesh.make_host_mesh(1, dev.type)
            real = {c["label"]: real_counts(c, dev, mesh, counted)
                    for c in cells_b}
            # kernels 1 and 2 on the rows the decode step packed
            params = real["decode"].pop("params")
            ffn, head = params.blocks[0].sub0.ffn, params.cam_head

            def packed(owner, prefix):
                return next(v[1] for k, v in owner.__dict__["_packed"].items()
                            if k.startswith(prefix + "@"))

            g = torch.Generator(dev).manual_seed(SEED + 52)
            rows = packed(ffn, "w_gate")[0]
            q = torch.randint(-2 ** 31, 2 ** 31 - 1, (LM_BATCH, rows.shape[1]),
                              generator=g, dtype=torch.int32, device=dev)
            require(torch.equal(binary_gemm.binary_gemm_hd(q, rows),
                                binary_gemm.binary_gemm_hd_plain(q, rows)),
                    "dry-run decode: binary_gemm_hd != plain on its rows")
            crow = packed(head, "rows")
            qc = torch.randint(-2 ** 31, 2 ** 31 - 1,
                               (LM_BATCH, crow.shape[1]), generator=g,
                               dtype=torch.int32, device=dev)
            thr = head.thresholds.to_local()
            require(torch.equal(cam_search.cam_vote(qc, crow, thr),
                                cam_search.cam_vote_plain(qc, crow, thr)),
                    "dry-run decode: cam_vote != plain on its rows")
            del params, ffn, head
            outs = [p.communicate(timeout=600) for p in procs]
            fake_out = fake.communicate(timeout=600)
            # the warm steps once the dry-runs have ended, so that no
            # other process loads the host while they are timed
            for r in real.values():
                r["warm_step_ms"] = warm_step_ms(r.pop("step"), dev)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    finally:
        for p in (*procs, fake):
            if p.poll() is None:
                p.kill()
    # ------------------------------------------------ (a) the cells
    for a, p, (so, se) in zip(DRY_RUNS, procs, outs):
        require(p.returncode == 0, f"dryrun {' '.join(a)}: exit "
                f"{p.returncode}: {(so + se)[-3000:]}")
    cells = {}
    for cid in DRY_CELLS:
        rec = json.loads((out_dir / f"{cid}.json").read_text())
        require(rec.get("status") == "ok", f"dryrun {cid}: {rec.get('error')}")
        rl, mem = rec["roofline"], rec["memory_analysis"]
        cells[cid] = dict(
            peak_gib=mem["peak_estimate_gib"], bottleneck=rl["bottleneck"],
            compute_s=rl["compute_s"], memory_s=rl["memory_s"],
            collective_s=rl["collective_s"], binary_s=rl["binary_s"],
            trace_s=rec["compile_s"], fake_device=rec["fake_device"],
            device_flops=rec["hlo_walker"]["device_flops"],
            device_binary_ops=rec["hlo_walker"]["device_binary_ops"],
            collectives=rec["hlo_walker"]["collective_count"])
        print(f"  dryrun {cid}: ok, peak {mem['peak_estimate_gib']} GiB/dev, "
              f"bottleneck {rl['bottleneck']}, compute {rl['compute_s']:.3e} "
              f"s, memory {rl['memory_s']:.3e} s, collective "
              f"{rl['collective_s']:.3e} s, trace {rec['compile_s']} s "
              f"({rec['fake_device']} fakes)")
    require(cells["llama3.2-1b+binary-ffn+cam-head__decode_32k__pod"]
            ["device_binary_ops"] > 0,
            "dryrun: kernels 1 and 2 counted no binary operations")
    # ------------------------------- (b) the card against the fakes
    require(fake.returncode == 0, f"dry-run (1, 1) cells: exit "
            f"{fake.returncode}: {fake_out[1][-3000:]}")
    line = next(ln for ln in fake_out[0].splitlines()
                if ln.startswith("DRY-COUNTS "))
    dry = json.loads(line.split(" ", 1)[1])
    counts = {}
    for label, r in real.items():
        d = dry[label]
        w, mem = d["hlo_walker"], d["memory_analysis"]
        for key, fake_v in (("flops", w["device_flops"]),
                            ("binary_ops", w["device_binary_ops"]),
                            ("hbm_bytes", w["device_hbm_bytes"]),
                            ("collective_count", w["collective_count"])):
            require(r[key] == fake_v, f"dry-run {label}: {key} on the card "
                    f"{r[key]} != fake {fake_v}")
        require(r["argument_bytes"] == mem["argument_bytes_per_device"],
                f"dry-run {label}: argument bytes {r['argument_bytes']} != "
                f"{mem['argument_bytes_per_device']}")
        est = (mem["argument_bytes_per_device"]
               + mem["output_bytes_per_device"]
               + mem["temp_bytes_per_device"]
               - mem["alias_bytes_per_device"])
        ratio = est / r["peak_allocated"] if r["peak_allocated"] else None
        require(ratio is None or abs(ratio - 1) <= DRY_PEAK_RTOL,
                f"dry-run {label}: peak estimate / max_memory_allocated "
                f"{ratio}")
        lb = d["roofline"]["step_time_lb_s"]
        counts[label] = dict(
            flops=r["flops"], binary_ops=r["binary_ops"],
            hbm_bytes=r["hbm_bytes"], collective_count=r["collective_count"],
            argument_bytes=r["argument_bytes"],
            argument_allocated=r["argument_allocated"],
            peak_estimate_bytes=est, peak_allocated=r["peak_allocated"],
            peak_ratio=ratio, launches=r["launches"],
            warm_step_ms=r["warm_step_ms"], step_time_lb_ms=lb * 1e3,
            lb_fraction=lb * 1e3 / r["warm_step_ms"],
            bottleneck=d["roofline"]["bottleneck"], trace_s=d["compile_s"])
        print(f"  dry-run {label} (1, 1) card == fake: flops {r['flops']:.6g},"
              f" binary {r['binary_ops']:.6g}, HBM {r['hbm_bytes']:.6g} B, "
              f"collectives {r['collective_count']}; arguments "
              f"{r['argument_bytes']} B (allocated {r['argument_allocated']});"
              f" peak estimate / max allocated {ratio}; roofline bound "
              f"{lb * 1e3:.4f} ms = {lb * 1e3 / r['warm_step_ms']:.4f} of a "
              f"warm step's {r['warm_step_ms']:.2f} ms ({smi})")
    launches = counts["decode"]["launches"]
    for name in ("binary_gemm_hd", "cam_vote"):
        require(launches[name] > 0 or dev.type != "cuda",
                f"{name} was not launched in the dry-run's decode step")
    phase_s = time.perf_counter() - t_phase
    print(f"dry-run phase: {phase_s:.1f} s")
    return dict(cells=cells, counts=counts, launches=launches,
                peak_rtol=DRY_PEAK_RTOL, phase_s=phase_s, card=smi)


# ------------------------------------------------- examples (phase 11)
# the four examples, in order, and the arguments each is run with (the
# reference's presets: quickstart --fast, lm_train --preset tiny)
EXAMPLES = (("torch_quickstart", ["--fast"]), ("torch_picbnn_serve", []),
            ("torch_lm_train", ["--preset", "tiny"]), ("torch_ft_demo", []))


def lm_to_cpu(module, make):
    """A copy on the CPU of an LM module (`make(device)` builds an empty
    one of its kind)."""
    cpu = make("cpu")
    cpu.load_state_dict({k: v.detach().cpu()
                         for k, v in module.state_dict().items()})
    return cpu


def plain_of(name: str):
    """The plain version of a kernel wrapper caught by `first_operands`,
    taking the wrapper's arguments."""
    from repro_torch.kernels import binary_gemm, cam_search, fused_conv, \
        fused_mlp

    def stage_plain(x, ws, cs, metas, *, bias_cells=0, kw_q=None):
        bias = fused_conv.bias_drive_words(bias_cells) if bias_cells else None
        return fused_conv.conv_stage_packed_plain(
            x, ws, cs, metas, bias,
            fused_conv._query_width(metas, bias_cells, kw_q))

    return {"binary_gemm_hd": binary_gemm.binary_gemm_hd_plain,
            "cam_vote": cam_search.cam_vote_plain,
            "fused_mlp_votes": fused_mlp.fused_mlp_votes_plain,
            "fused_conv_votes": fused_conv.fused_conv_votes_plain,
            "conv_stage_packed": stage_plain}[name]


def call_work(name: str, args, kw):
    """The work of one caught call of kernel 2, 3 or 4 (or 4's stage
    entry) as `Card.bound_ms` takes it, from its operands alone:
    `conv_work` / `tail_work` on a stand-in of the pipeline that made
    the call (the head's bits: the last layer's outputs and the bias
    cells; a query's words, 32 bits each, where no layer comes before
    the head), the [B, C, P] sampled thresholds read once."""
    from types import SimpleNamespace as NS

    from repro_torch.kernels import fused_conv

    def pipe(layer_ws, n_bits, head, q_bits, conv=None):
        bias = kw.get("bias_cells", 0)
        bits = (layer_ws[-1].shape[0] if layer_ws else q_bits) + bias
        return NS(conv=conv, layer_ws=layer_ws, layer_n_bits=n_bits,
                  head=NS(cam=NS(rows_packed=head, n_bits=bits)))

    x = args[0]
    if name in ("fused_conv_votes", "conv_stage_packed"):
        ws, metas = args[1], args[3]
        conv = NS(side=x.shape[1], metas=metas, ws=ws)
        if name == "conv_stage_packed":
            kw_q = fused_conv._query_width(metas, kw.get("bias_cells", 0),
                                           kw.get("kw_q"))
            return conv_work(NS(conv=conv), x.shape[0], 0, True, kw_q)
        layer_ws, _, n_bits, head, thr = args[4:9]
        flat = metas[-1].out_side ** 2 * metas[-1].c_out
        work = list(conv_work(pipe(layer_ws, n_bits, head, flat, conv),
                              x.shape[0], thr.shape[0], False))
    else:
        layer_ws, n_bits, head, thr = ((), (), *args[1:3]) \
            if name == "cam_vote" else (args[1], args[3], *args[4:6])
        work = list(tail_work(pipe(layer_ws, n_bits, head, 32 * x.shape[1]),
                              x.shape[0], thr.shape[0]))
        work[2] += 4 * x.numel()
    if kw.get("thr_samples") is not None:
        work[2] += 4 * kw["thr_samples"].numel()
    return work


def caught_rows(card, seen: dict, label: str) -> dict:
    """Every form of kernel call caught by `first_operands`, on the
    operands of its first call, held against its plain version
    (torch.equal) and timed beside its bound: kernels 1 and 2 by
    `gemm_case` / `vote_case` (with their library call, `lm_kernel_rows`),
    the rest (kernel 2 with sampled thresholds, 3, 4, 4's stage entry)
    with none.  Returns {kernel: [row, ...]}."""
    from repro_torch.kernels import fused_conv, fused_mlp, ops

    wrappers = {"binary_gemm_hd": ops.binary_gemm_hd,
                "cam_vote": ops.cam_vote,
                "fused_mlp_votes": fused_mlp.fused_mlp_votes,
                "fused_conv_votes": fused_conv.fused_conv_votes,
                "conv_stage_packed": fused_conv.conv_stage_packed}
    rows: dict = {}
    with torch.no_grad():
        for (name, *_), (args, kw) in seen.items():
            if name == "binary_gemm_hd":
                rows.setdefault(name, []).extend(lm_kernel_rows(
                    card, name, [gemm_case(label, *args)]))
                continue
            if name == "cam_vote" and kw.get("thr_samples") is None:
                rows.setdefault(name, []).extend(lm_kernel_rows(
                    card, name, [vote_case(label, *args)]))
                continue
            fn, plain = wrappers[name], plain_of(name)
            got, want = fn(*args, **kw), plain(*args, **kw)
            require(torch.equal(got, want),
                    f"{label} {name} {operand_key(name, args, kw)[1:]}: "
                    "kernel != plain")
            row = dict(shape=f"{label} {name} x{list(args[0].shape)}"
                       + (" sampled" if kw.get("thr_samples") is not None
                          else ""),
                       ms=device_ms(lambda: fn(*args, **kw), iters=20),
                       call_ms=time_ms(lambda: fn(*args, **kw), 20),
                       plain_ms=time_ms(lambda: plain(*args, **kw), 3),
                       **bound_fields(card, *call_work(name, args, kw)),
                       library_ms=None,
                       max_abs_err=int((got - want).abs().max())
                       if got.numel() else 0)
            rows.setdefault(name, []).append(row)
            print(f"  {name} {row['shape']}: == plain; kernel {row['ms']} "
                  f"ms (call {row['call_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} "
                  f"ms ({row['bound_route']})")
    return rows


def examples_phase(dev, smi: str, card, counted) -> dict:
    """Phase 11: the four examples (`examples/torch_*.py`) in this
    process, each through its `main(argv)` with no device argument on the
    card (`--device` only in a CPU rehearsal), every launch counter set
    to 0 just before the first; each example's wall seconds and its
    launches.  Kernels 3 and 4 must launch in the quickstart, kernels 1
    and 2 in picbnn_serve.  Every kernel call is caught
    (`first_operands`), and each kernel must have been called at least
    as often as it launched (no launch by another route); on the
    operands of its first call of each form each kernel equals its plain
    version (`caught_rows`, which times it beside its bound).  Checks:
    the quickstart's deployed noiseless votes and predictions (MLP and
    CNN) equal the same `Deployment` run on the CPU, its served
    predictions the direct ones; picbnn_serve's vote and exact streams
    and its pass sweep equal the same computation on the CPU on the same
    weights; lm_train's 60 losses are finite; ft_demo restarts twice and
    ends on the failure-free run's parameters."""
    import importlib

    from repro_torch import configs
    from repro_torch.models import binary_lm
    from repro_torch.models import model as M
    from repro_torch.spec import InferenceSpec

    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    mods = {name: importlib.import_module(name) for name, _ in EXAMPLES}
    extra = [] if dev.type == "cuda" else ["--device", str(dev)]
    t_phase = time.perf_counter()
    for fn in counted:
        fn.launches = 0
    outs, runs, seen, calls = {}, {}, {}, {}
    with first_operands(seen, calls):
        for name, argv in EXAMPLES:
            before = {fn.__name__: fn.launches for fn in counted}
            t0 = time.perf_counter()
            outs[name] = mods[name].main(argv + extra)
            sync(dev)
            runs[name] = dict(
                wall_s=time.perf_counter() - t0,
                launches={fn.__name__: fn.launches - before[fn.__name__]
                          for fn in counted})
            print(f"  example {name} {' '.join(argv)}: "
                  f"{runs[name]['wall_s']:.1f} s, launches "
                  f"{runs[name]['launches']}")
    launches = {fn.__name__: fn.launches for fn in counted}
    on_card = dev.type == "cuda"
    for k, n in launches.items():
        require(calls.get(k, 0) >= n,
                f"examples: {k} launched {n} times, called {calls.get(k)}")
    # every form of call on the path against its plain version
    rows = caught_rows(card, seen, "examples")
    require(set(rows) >= {k for k, n in launches.items() if n},
            f"examples: launched kernels without a checked call: "
            f"{launches} {list(rows)}")
    del seen
    for name, kernels in (("torch_quickstart", ("fused_mlp_votes",
                                                "fused_conv_votes")),
                          ("torch_picbnn_serve", ("cam_vote",
                                                  "binary_gemm_hd"))):
        for k in kernels:
            require(runs[name]["launches"][k] > 0 or not on_card,
                    f"{k} was not launched in {name}")

    # the quickstart: card == CPU on the same folded weights, the raw
    # int32 votes and the predictions
    qs, argmax = outs["torch_quickstart"], InferenceSpec(reduction="argmax")
    made = qs["made"]
    for dep, x in (("dep", "vxb"), ("cnn_dep", "vx")):
        got = made[dep].run(made[x], InferenceSpec())
        want = made[dep].pipeline("cpu").run(made[x], InferenceSpec())
        require(got.dtype == torch.int32 and torch.equal(got.cpu(), want),
                f"quickstart: {dep}'s votes on the card != the CPU's")
    mlp_cpu = made["dep"].pipeline("cpu").run(made["vxb"], argmax)
    require(torch.equal(made["pred"], mlp_cpu.cpu()),
            "quickstart: MLP predictions on the card != the CPU's")
    cnn_cpu = made["cnn_dep"].pipeline("cpu").run(made["vx"], argmax)
    require(torch.equal(made["cnn_pred"], cnn_cpu.cpu()),
            "quickstart: CNN predictions on the card != the CPU's")
    require(qs["served_pred0"] == qs["direct_pred0"]
            and np.array_equal(made["served"], made["pred"].numpy()[:512]),
            "quickstart: served predictions != direct")
    require(qs["served_cnn_pred0"] == qs["direct_cnn_pred0"],
            "quickstart: served CNN prediction != direct")
    # picbnn_serve: the same computation on the CPU, on the same weights
    ps = outs["torch_picbnn_serve"]
    mod = mods["torch_picbnn_serve"]
    cfg_v = configs.get_config(mod.ARCH + "+cam-head")
    cfg_e = configs.get_config(mod.ARCH + "+cam-head-exact")
    params = lm_to_cpu(ps["made"]["params"],
                       lambda d: M.CausalLM(cfg_v, d))
    heads = {n: lm_to_cpu(h, lambda d, h=h: binary_lm.CamHead(h.cfg, d))
             for n, h in ps["made"]["heads"].items()}
    ps_cpu = mod.run(params, cfg_e, cfg_v, heads, torch.device("cpu"))
    for stream in ("adc-exact-readout", "picbnn-votes"):
        require(np.array_equal(ps["made"]["streams"][stream],
                               ps_cpu["made"]["streams"][stream]),
                f"picbnn_serve: {stream} stream on the card != the CPU's")
    require(ps["sweep"] == ps_cpu["sweep"],
            "picbnn_serve: the pass sweep on the card != the CPU's")
    lt, ft = outs["torch_lm_train"], outs["torch_ft_demo"]
    require(lt["steps"] >= 60 and bool(np.isfinite(lt["losses"]).all()),
            "lm_train: fewer than 60 finite losses")
    require(ft["params_identical"] is True and ft["restarts"] == 2,
            f"ft_demo: restarts {ft['restarts']}, params identical "
            f"{ft['params_identical']}")
    phase_s = time.perf_counter() - t_phase
    print(f"  quickstart: card == CPU (MLP and CNN votes and predictions), "
          f"served == "
          f"direct; picbnn_serve: streams and sweep card == CPU; lm_train "
          f"{lt['steps']} finite losses; ft_demo {ft['restarts']} restarts, "
          f"params identical")
    print(f"examples phase: {phase_s:.1f} s")
    numbers = {name: {k: v for k, v in out.items()
                      if k not in ("made", "losses")}
               for name, out in outs.items()}
    return dict(runs=runs, launches=launches, calls=calls, kernels=rows,
                numbers=numbers, phase_s=phase_s, card=smi)


# ---------------------------------------------------------------------------
# LFM2-8B-A1B's prefill kernels (phase 12)
# ---------------------------------------------------------------------------
LFM2_ARCH = "lfm2-8b-a1b+binary-ffn"
LFM2_PROMPTS, LFM2_TOKENS = 2, 2048  # the benchmark cell's call
LFM2_TIMED_PROMPTS = (2, 4)


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of want's last bfloat16 bit."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return float(((got.float() - w).abs() / ulp).max())


def _lfm2_loads(gen, slots: int, experts: int) -> list:
    """Loads of `slots` over `experts`, uneven as a biased router's, with
    expert 1 given none."""
    w = torch.rand(experts, generator=gen) ** 3
    w[1] = 0.0
    loads = (w / w.sum() * slots).floor().long()
    loads[int(w.argmax())] += slots - int(loads.sum())
    return loads.tolist()


def _lfm2_kernel(name, ms, bound, shape, **err) -> dict:
    return dict(name=name, shape=shape, ms=ms, **bound, **err)


def lfm2_kernel_rows(dev, card: Card, cfg) -> dict:
    """Phase 12's kernel checks at the cell's shapes: {kernel: row}."""
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import expert_ffn
    from repro_torch.kernels import rows as row_ops

    gen = torch.Generator().manual_seed(SEED + 25)
    dgen = torch.Generator(dev).manual_seed(SEED + 25)
    t, k, e = LFM2_PROMPTS * LFM2_TOKENS, cfg.moe_top_k, cfg.n_experts
    d, f, s = cfg.d_model, cfg.expert_d_ff, t * k
    loads = _lfm2_loads(gen, s, e)
    offsets = torch.tensor([0, *torch.tensor(loads).cumsum(0).tolist()],
                           dtype=torch.int32, device=dev)
    expert = torch.repeat_interleave(
        torch.arange(e, device=dev), torch.tensor(loads, device=dev)).to(
        torch.int32)
    rows = {}

    def words(*shape):
        return torch.randint(-2**31, 2**31 - 1, shape, generator=dgen,
                             device=dev, dtype=torch.int64).to(torch.int32)

    # kernel 1's grouped entry: gate and up as one, then down
    for label, kw, n in (("gate_up", d // 32, 2 * f), ("down", f // 32, d)):
        x, w = words(s, kw), words(e, n, kw)
        got = bg.grouped_bitlinear_hd(x, offsets, w)
        require(torch.equal(got, bg.grouped_bitlinear_hd_plain(x, offsets,
                                                               w)),
                f"grouped_bitlinear_hd {label}: kernel != plain")
        pairs = s * n * kw
        rows.setdefault("grouped_bitlinear_hd", []).append(_lfm2_kernel(
            label, device_ms(lambda: bg.grouped_bitlinear_hd(x, offsets, w),
                             iters=20),
            bound_fields(card, pairs, 2 * pairs,
                         4 * (s * kw + e * n * kw + s * n), 32 * pairs, 0),
            f"x[{s},{kw}] w[{e},{n},{kw}] loads {min(loads)}-{max(loads)}",
            max_abs_err=0))
    # SwiGLU and the down operands' signs; the combine
    hd = torch.randint(0, d + 1, (s, 2 * f), generator=dgen, device=dev,
                       dtype=torch.int32)
    alpha = torch.rand((e, 2 * f), generator=dgen, device=dev).to(
        torch.bfloat16)
    beta = torch.rand((s,), generator=dgen, device=dev).to(torch.bfloat16)
    bits, b_act = expert_ffn.swiglu_signs(hd, alpha, beta, expert, d)
    want_bits, want_b = expert_ffn.swiglu_signs_plain(hd, alpha, beta,
                                                      expert, d)
    ulps = bf16_ulps(b_act, want_b)
    require(torch.equal(bits, want_bits) and ulps <= 1,
            f"expert_swiglu_signs: kernel != plain ({ulps} bf16 bits)")
    rows["expert_swiglu_signs"] = [_lfm2_kernel(
        "swiglu", device_ms(lambda: expert_ffn.swiglu_signs(
            hd, alpha, beta, expert, d), iters=20),
        bound_fields(card, 0, 0, 4 * s * 2 * f + 2 * e * 2 * f + 2 * s
                     + 4 * s + 4 * s * (f // 32) + 2 * s, 0, 0),
        f"hd[{s},{2 * f}]", beta_ulps=ulps)]
    hd2 = torch.randint(0, f + 1, (s, d), generator=dgen, device=dev,
                        dtype=torch.int32)
    alpha2 = torch.rand((e, d), generator=dgen, device=dev).to(torch.bfloat16)
    back = torch.randperm(s, generator=dgen, device=dev)
    gate = torch.rand((t, k), generator=dgen, device=dev)
    got = expert_ffn.combine(hd2, alpha2, want_b, expert, back, gate, f)
    want = expert_ffn.combine_plain(hd2, alpha2, want_b, expert, back, gate,
                                    f)
    require(torch.equal(got, want), "expert_combine: kernel != plain")
    rows["expert_combine"] = [_lfm2_kernel(
        "combine", device_ms(lambda: expert_ffn.combine(
            hd2, alpha2, want_b, expert, back, gate, f), iters=20),
        bound_fields(card, 0, 0, 4 * s * d + 2 * e * d + 2 * s + 4 * s
                     + 8 * s + 4 * s + 2 * t * d, 0, 0),
        f"hd[{s},{d}] -> y[{t},{d}]", max_abs_err=0)]
    # the RMS norm and a BitLinear input's signs and beta
    x = torch.randn((t, d), generator=dgen, device=dev).to(torch.bfloat16)
    scale = (1 + 0.2 * torch.randn(d, generator=dgen, device=dev)).to(
        torch.bfloat16)
    ulps = bf16_ulps(row_ops.rms_norm(x, scale, cfg.norm_eps),
                     row_ops.rms_norm_plain(x, scale, cfg.norm_eps))
    require(ulps <= 1, f"rms_norm_rows: kernel != plain ({ulps} bf16 bits)")
    rows["rms_norm_rows"] = [_lfm2_kernel(
        "rms_norm", device_ms(lambda: row_ops.rms_norm(x, scale,
                                                       cfg.norm_eps),
                              iters=20),
        bound_fields(card, 0, 0, 2 * 2 * t * d + 2 * d, 0, 0),
        f"x[{t},{d}] bf16", norm_ulps=ulps)]
    (bits, b), (want_bits, want_b) = row_ops.sign_rows(x), \
        row_ops.sign_rows_plain(x)
    ulps = bf16_ulps(b, want_b)
    require(torch.equal(bits, want_bits) and ulps <= 1,
            f"sign_rows: kernel != plain ({ulps} bf16 bits)")
    rows["sign_rows"] = [_lfm2_kernel(
        "sign_rows", device_ms(lambda: row_ops.sign_rows(x), iters=20),
        bound_fields(card, 0, 0, 2 * t * d + 4 * t * (d // 32) + 2 * t,
                     0, 0),
        f"x[{t},{d}] bf16", beta_ulps=ulps)]
    for name, rs in rows.items():
        for r in rs:
            print(f"  {name} {r['shape']}: {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_route']})")
    return rows


def lfm2_phase(dev, card: Card, smi: str) -> dict:
    """Phase 12 (module docstring): the LFM2 prefill's kernels at the
    cell's shapes, then their launches in one prefill of the model at its
    published widths, and the call's time at 2 and 4 prompts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import binary_gemm as bg
    from repro_torch.kernels import expert_ffn
    from repro_torch.kernels import rows as row_ops
    from repro_torch.models.model import (init_params, prefill,
                                          prefill_graphed)

    cfg = get_config(LFM2_ARCH)
    rows = lfm2_kernel_rows(dev, card, cfg)
    counted = {"grouped_bitlinear_hd": bg.grouped_bitlinear_hd,
               "expert_swiglu_signs": expert_ffn.swiglu_signs,
               "expert_combine": expert_ffn.combine,
               "rms_norm_rows": row_ops.rms_norm,
               "sign_rows": row_ops.sign_rows}
    pat = cfg.pattern()
    moe, attn = sum(pat.moe_mask), pat.kinds.count("attn")
    want = {"grouped_bitlinear_hd": 2 * moe, "expert_swiglu_signs": moe,
            "expert_combine": moe, "rms_norm_rows": 2 * cfg.n_layers
            + 2 * attn + 1, "sign_rows": moe}
    gen = torch.Generator(dev).manual_seed(SEED + 26)
    reset_peak(dev)
    model = init_params(cfg, gen, dev)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("expert_bias"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen,
                                            device=dev))
    call_ms = {}
    for b in LFM2_TIMED_PROMPTS:
        tok = torch.randint(0, cfg.vocab_size, (b, LFM2_TOKENS),
                            generator=gen, device=dev)
        prefill(model, cfg, tok, max_len=LFM2_TOKENS)  # builds and packs
        torch.cuda.synchronize()
        if b == LFM2_PROMPTS:
            for fn in counted.values():
                fn.launches = 0
            logits, _ = prefill(model, cfg, tok, max_len=LFM2_TOKENS)
            torch.cuda.synchronize()
            launches = {n: fn.launches for n, fn in counted.items()}
            print(f"LFM2 prefill [{b}, {LFM2_TOKENS}]: launches {launches}")
            require(launches == want,
                    f"LFM2 prefill launches {launches}, expected {want}")
            require(bool(torch.isfinite(logits).all()),
                    "LFM2 prefill: logits not finite")
        call_ms[b] = dict(
            op_by_op=time_ms(lambda: prefill(model, cfg, tok,
                                             max_len=LFM2_TOKENS), 10),
            graphed=time_ms(lambda: prefill_graphed(
                model, cfg, tok, max_len=LFM2_TOKENS), 10))
        print(f"LFM2 prefill [{b}, {LFM2_TOKENS}]: ms a call {call_ms[b]} "
              f"({smi})")
    peak = peak_gb(dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return dict(kernels=rows, launches=launches, call_ms=call_ms,
                peak_gb=peak, card=smi)


# the input packing's shapes (phase 13): the HG cells' 32,768 rows of
# 4,096 floats (the MLP's ±1 inputs, the CNN's 64 x 64 pixels at
# thermometer-4), and MNIST's 784 (the MLP, the CNN at thermometer-8)
PACK_ROWS = 32768
PACK_SHAPES = (("hg_mlp", 4096, None), ("hg_cnn", 4096, 4),
               ("mnist_mlp", 784, None), ("mnist_cnn", 784, 8))


def pack_phase(dev, card: Card, smi: str) -> dict:
    """Phase 13 (module docstring): the input-packing kernel's two entries
    (`kernels/pack_input.py`) at the cells' shapes against their plain
    twins (`binarize.pack_pm1`, `InputEncoding.pack`) on the card, timed
    beside the bytes bound (float32 rows in, words out); then the launches
    of one `run` of an HG MLP and an HG CNN pipeline at the cells' batch."""
    from repro_torch.configs.paper_cnn import HG_CNN, build_cnn_pipeline
    from repro_torch.configs.paper_mlp import HG_MLP, PAPER_ENSEMBLE
    from repro_torch.core import binarize, bnn, convnet
    from repro_torch.kernels import pack_input
    from repro_torch.pipeline import compile_pipeline
    from repro_torch.spec import InferenceSpec

    gen = torch.Generator(dev).manual_seed(SEED + 13)
    rows = {}
    for name, n, width in PACK_SHAPES:
        x = torch.rand((PACK_ROWS, n), generator=gen, device=dev)
        if width is None:
            x = 2 * x - 1

            def kernel():
                return pack_input.sign_words(x)

            def plain():
                return binarize.pack_pm1(x)
            out_bytes = PACK_ROWS * binarize.packed_width(n) * 4
        else:
            enc = binarize.InputEncoding("thermometer", width)

            def kernel():
                return pack_input.threshold_words(x, enc)

            def plain():
                return enc.pack(x)
            out_bytes = x.numel() * binarize.packed_width(width) * 4
        require(torch.equal(kernel(), plain()),
                f"pack {name} [{PACK_ROWS}, {n}]: kernel != plain")
        nbytes = x.numel() * 4 + out_bytes
        rows[name] = row = dict(
            entry="sign_words" if width is None else "threshold_words",
            shape=f"[{PACK_ROWS},{n}]" + ("" if width is None
                                          else f" thermometer-{width}"),
            ms=device_ms(kernel, iters=20), call_ms=time_ms(kernel, 20),
            plain_ms=device_ms(plain, iters=2, replays=2),
            bound_ms=nbytes / MEM_BYTES_PER_S * 1e3, bound_by="bytes",
            bound_route="bytes", bytes=nbytes)
        row["bandwidth_tb_s"] = nbytes / row["ms"] / 1e9
        print(f"  pack {name:9s} {row['shape']}: kernel {row['ms']:.4f} ms "
              f"(call {row['call_ms']:.4f} ms, "
              f"{row['bandwidth_tb_s']:.2f} TB/s), plain "
              f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({smi})")
        del x
    # launches in one run() of each HG pipeline at the cells' batch
    mlp = compile_pipeline(random_folded(HG_MLP.layer_sizes, SEED + 1,
                                         HG_MLP.bias_cells, bnn),
                           PAPER_ENSEMBLE, device=dev)
    cnn = build_cnn_pipeline(HG_CNN, convnet.random_folded_cnn(
        HG_CNN, seed=SEED + 3), device=dev)
    launches = {}
    for name, pipe, fn, x in (
            ("hg_mlp", mlp, pack_input.sign_words,
             2 * torch.rand((PACK_ROWS, 4096), generator=gen, device=dev)
             - 1),
            ("hg_cnn", cnn, pack_input.threshold_words,
             torch.rand((PACK_ROWS, 4096), generator=gen, device=dev))):
        pipe.run(x, InferenceSpec())
        before = fn.launches
        pipe.run(x, InferenceSpec())
        torch.cuda.synchronize()
        launches[name] = fn.launches - before
        rows[name]["launches_a_call"] = launches[name]
    print(f"  pack launches a run() call: {launches}")
    require(launches == {"hg_mlp": 1, "hg_cnn": 1},
            f"pack launches a run() call {launches}, expected 1 each")
    del mlp, cnn
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, launches=launches, card=smi)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    # cuBLAS's deterministic workspace, read when its handle is made:
    # phase 8 runs the fault-tolerance demo with deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    for name in _build.SOURCES:
        ops = [[t for t in ln.split(";")[0].split("*/")[-1].split()
                if not t.startswith("@")]  # the mnemonic after a predicate
               for ln in _build.sass(_build.build_dir() / f"{name}.so")
               .splitlines() if "MMA" in ln]
        n_imma = sum(1 for o in ops if o and o[0].startswith("IMMA"))
        n_bmma = sum(1 for o in ops if o and o[0].startswith("BMMA"))
        kinds = sorted({o[0] for o in ops if o})
        print(f"  SASS {name}: IMMA {n_imma}, BMMA {n_bmma} {kinds}")
        if name in TENSOR_CORE_LIBS:
            require(n_imma + n_bmma > 0,
                    f"{name}: no tensor-core MMA (IMMA/BMMA) in its SASS")
    kernels = run(torch.device("cuda", 0), B_MAIN, MAIN_BATCHES, card, smi)
    print(f"smoke: {time.perf_counter() - t0:.1f} s after the build began")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev: torch.device, b_main: int, batches, card: Card,
        smi: str) -> list:
    """Phases 2-13 on `dev`; returns the kernels line's entries.

    Called with the card by `main`; a CPU rehearsal may call it with
    device "cpu" and small batches (every kernel then takes its plain
    version, so the kernel checks are trivially equal).
    """
    from repro_torch.configs.paper_cnn import (HG_CNN, MNIST_CNN,
                                               build_cnn_pipeline)
    from repro_torch.configs.paper_mlp import HG_MLP, MNIST_MLP, PAPER_ENSEMBLE
    from repro_torch.core import binarize, bnn, convnet, ensemble
    from repro_torch.kernels import (binary_gemm, cam_search, fused_conv,
                                     fused_mlp, ops, pack_input, ref)
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
    # the paper's CNNs: raw [0, 1] pixels in, thermometer input layer
    cnns = {}
    on_dev = {} if on_card else {"device": dev}
    for mid, cfg, seed in (("mnist_cnn", MNIST_CNN, SEED + 2),
                           ("hg_cnn", HG_CNN, SEED + 3)):
        folded = convnet.random_folded_cnn(cfg, seed=seed)
        cnns[mid] = dict(
            cfg=cfg, folded=folded,
            gpu=build_cnn_pipeline(cfg, folded, **on_dev),
            cpu=build_cnn_pipeline(cfg, folded, device="cpu"),
            x=rng.random((b_main, cfg.n_in)).astype(np.float32),
        )
    require(all(m["gpu"].device == dev for m in cnns.values()),
            "build_cnn_pipeline() with no device did not land on the card")

    # ------------------------------------ kernels against their plain twins
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {k: {"per_model": {}} for k in REPLACES}
    # kernel 4: the paper CNNs at B = 4096, timed; the test configs with
    # unaligned channels (24 -> 20, stride 1) and a head-direct net at a
    # small batch
    for mid, m in cnns.items():
        xp = m["gpu"].conv.maps(m["gpu"].conv.pack(
            torch.from_numpy(m["x"]).to(dev)))
        check_conv_kernels(m["gpu"], xp, gen, card, mid, report, True)
    enc = binarize.InputEncoding
    for mid, cfg in (
            ("unaligned", convnet.CNNConfig(
                side=12, encoding=enc("thermometer", 3),
                conv=(convnet.ConvSpec(3, 24, 2), convnet.ConvSpec(3, 20, 1)),
                hidden=(48,), n_classes=7)),
            ("head-dir", convnet.CNNConfig(
                side=10, encoding=enc("thermometer", 2),
                conv=(convnet.ConvSpec(3, 32, 2),), hidden=(), n_classes=5))):
        pipe = build_cnn_pipeline(cfg, convnet.random_folded_cnn(cfg, seed=5),
                                  device=dev)
        x = torch.from_numpy(rng.random((333, cfg.n_in)).astype(np.float32))
        check_conv_kernels(pipe, pipe.conv.maps(pipe.conv.pack(x.to(dev))),
                           gen, card, mid, report, False)
    for k in ("fused_conv_votes", "conv_stage_packed"):
        for mid, row in report[k]["per_model"].items():
            prev = PREV_MS[k][mid == "mnist_cnn"]
            print(f"  {mid:9s} {k:17s} {row['shape']}: kernel {row['ms']} ms "
                  f"(prev {prev}; call {row['call_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_route']})")
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
        forms = threshold_forms(thr, b, n_cls, gen, dev)

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
        report["binary_gemm_hd"]["per_model"][mid] = gemm_row(
            card, xp, w1,
            device_ms(lambda: binary_gemm.binary_gemm_hd(xp, w1)),
            time_ms(lambda: binary_gemm.binary_gemm_hd(xp, w1), 100),
            time_ms(lambda: binary_gemm.binary_gemm_hd_plain(xp, w1), 3),
            device_ms(lambda: torch._int_mm(x_i8, w_i8.t())),
            int((k1 - k1_plain).abs().max()))

        # kernel 2: the head vote, all three threshold forms
        errs = []
        for form, t, s in forms:
            got = cam_search.cam_vote(q, head, t, thr_samples=s)
            want = cam_search.cam_vote_plain(q, head, t, thr_samples=s)
            require(torch.equal(got, want), f"{mid}: cam_vote[{form}] != plain")
            errs.append(int((got - want).abs().max()))
        k2_call = time_ms(lambda: cam_search.cam_vote(q, head, thr), 100)
        k2_ms = device_ms(lambda: cam_search.cam_vote(q, head, thr))
        k2_plain_ms = time_ms(
            lambda: cam_search.cam_vote_plain(q, head, thr), 3)
        # the library yardstick: the reference's float32 ±1 product of the
        # unpacked operands and the compare (`vote_case`)
        k2_lib = vote_case(mid, q, head, thr)[3]
        require(torch.equal(k2_lib().to(torch.int32),
                            cam_search.cam_vote(q, head, thr)),
                f"{mid}: float32 ±1 torch.matmul + compare != cam_vote")
        pairs = b * n_cls * kw_h
        vote = 2 * b * n_cls * p
        report["cam_vote"]["per_model"][mid] = dict(
            shape=f"q[{b},{kw_h}] rows[{n_cls},{kw_h}] P={p}", ms=k2_ms,
            call_ms=k2_call, plain_ms=k2_plain_ms, **bound_fields(
                card, pairs, 2 * pairs + vote,
                4 * (b * kw_h + n_cls * kw_h + p + b * n_cls), 32 * pairs,
                vote),
            library_ms=device_ms(k2_lib),
            library="float32 ±1 torch.matmul + compare",
            max_abs_err=max(errs))

        # kernel 3: the whole net, all three threshold forms
        args = (xp, pipe.layer_ws, pipe.layer_cs, pipe.layer_n_bits, head)
        errs = []
        for form, t, s in forms:
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
        beside = 2 * b * n_hidden + 2 * b * n_cls * p
        nbytes = 4 * (b * kw0 + n_hidden * kw0 + n_hidden + n_cls * kw_h + p
                      + b * n_cls)
        macs = b * (n_hidden * n1 + n_cls * pipe.head.cam.n_bits)
        report["fused_mlp_votes"]["per_model"][mid] = dict(
            shape=f"x[{b},{kw0}] {m['cfg'].layer_sizes} P={p}", ms=k3_ms,
            call_ms=k3_call, plain_ms=k3_plain_ms, **bound_fields(
                card, pairs, 2 * pairs + beside, nbytes, macs, beside),
            library_ms=None, max_abs_err=max(errs))
        for k in ("binary_gemm_hd", "cam_vote", "fused_mlp_votes"):
            row = report[k]["per_model"][mid]
            prev = PREV_MS[k][mid == "mnist"]
            print(f"  {mid:5s} {k:16s} {row['shape']}: kernel "
                  f"{row['ms']} ms (prev {prev}; call "
                  f"{row['call_ms']:.4f} ms), plain "
                  f"{row['plain_ms']:.3f} ms, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_route']}), library "
                  f"{row['library_ms']}")

    # ------------------- end to end: one run() call, input already on dev
    e2e = {}
    for mid, m in {**models, **cnns}.items():
        for bsz in batches:
            xd = torch.from_numpy(m["x"][:bsz]).to(dev)
            for sname, spec in (("votes", InferenceSpec()),
                                ("cumulative", InferenceSpec(cumulative=True))):
                ms = time_ms(lambda: m["gpu"].run(xd, spec), 20)
                e2e[f"{mid}/B={bsz}/{sname}"] = dict(ms=ms,
                                                     inf_per_s=bsz / ms * 1e3)
                print(f"  run {mid:9s} B={bsz:5d} {sname:10s}: {ms:.4f} ms "
                      f"-> {bsz / ms * 1e3:,.0f} inf/s")
    # the CNN input layer alone (ConvFront.pack: the packing kernel on the
    # card) at the largest batch
    for mid, m in cnns.items():
        xd = torch.from_numpy(m["x"]).to(dev)
        pack = m["gpu"].conv.pack
        ms, dms = time_ms(lambda: pack(xd), 20), device_ms(lambda: pack(xd),
                                                           iters=20)
        e2e[f"{mid}/B={b_main}/pack"] = dict(ms=ms, device_ms=dms)
        print(f"  pack {mid:9s} B={b_main:5d}: {ms:.4f} ms "
              f"(device {dms} ms)")
    print(json.dumps({"e2e": e2e, "card": smi}))
    # where the HG MLP's run() goes at the largest batch: device kernels
    # against the rest of the call (host work, launches, waits)
    xd = torch.from_numpy(models["hg"]["x"]).to(dev)
    split = profile_split(lambda: models["hg"]["gpu"].run(xd, InferenceSpec()),
                          20)
    print(f"  profile hg B={b_main} run() votes: {split['call_ms']:.4f} ms "
          f"a call, device kernels {split['device_kernel_ms']:.4f} ms, "
          f"the rest {split['rest_ms']:.4f} ms")
    print(json.dumps({"profile": {f"hg/B={b_main}/votes": split,
                                  "card": smi}}))

    # ------------------------------------------------------ the main path
    specs = {"votes": InferenceSpec(),
             "argmax": InferenceSpec(reduction="argmax"),
             "cumulative": InferenceSpec(cumulative=True)}
    counted = (binary_gemm.binary_gemm_hd, cam_search.cam_vote,
               fused_mlp.fused_mlp_votes, fused_conv.fused_conv_votes,
               fused_conv.conv_stage_packed)
    # the input packing's entries, counted on this path only (the later
    # phases check that each kernel in `counted` has a checked call)
    packers = (pack_input.sign_words, pack_input.threshold_words)
    served_models = {**models, **cnns}
    for fn in (*counted, *packers):
        fn.launches = 0
    results = {}
    t0 = time.perf_counter()
    for mid, m in served_models.items():
        for bsz in batches:
            for sname, spec in specs.items():
                results[(mid, bsz, sname)] = m["gpu"].run(m["x"][:bsz], spec)
    policy = BatchingPolicy(max_batch=256, max_wait_us=500)
    served = {}
    server = PicBnnServer(policy, devices=None if on_card else [dev])
    for mid, m in served_models.items():
        server.register(mid, m["gpu"])
    server.warmup()
    with server:
        singles = {mid: [server.submit(mid, m["x"][i]) for i in range(100)]
                   for mid, m in served_models.items()}
        bursts = {mid: server.submit_many(mid, m["x"][100:400])
                  for mid, m in served_models.items()}
        for mid in served_models:
            served[mid] = np.concatenate(
                [np.stack([h.result(timeout=60).votes
                           for h in singles[mid]]),
                 bursts[mid].votes_all(timeout=60)])
    if on_card:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in (*counted, *packers)}
    stats = server.stats()
    print(f"main path: {main_s:.2f} s, launches {launches}")
    print(stats.summary())
    for fn in (binary_gemm.binary_gemm_hd, fused_mlp.fused_mlp_votes,
               fused_conv.fused_conv_votes, fused_conv.conv_stage_packed,
               *packers):
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
    n_req = sum(len(m["x"][:400]) for m in served_models.values())
    require(stats.n_requests == n_req,
            f"server answered {stats.n_requests} of {n_req} requests")

    # -------------------------------------------- correctness of the output
    for mid, m in served_models.items():
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
        if mid in cnns:  # the unpacked ±1 CNN oracle
            oracle = ref.conv_votes_ref(m["folded"], m["cpu"].head, x100,
                                        m["cfg"].encoding, m["cfg"].side)
        else:  # folded_forward_exact + votes_fused
            h = torch.where(
                bnn.folded_forward_exact(m["folded"][:-1], x100) >= 0,
                1.0, -1.0)
            oracle = ensemble.votes_fused(m["cpu"].head, h)
            require(torch.equal(
                op_votes[mid].cpu(),
                ensemble.votes_fused(m["cpu"].head, m["hidden_pm1"].cpu())),
                f"{mid}: ops.cam_vote != votes_fused")
        require(torch.equal(results[(mid, 100, "votes")].cpu(), oracle),
                f"{mid}: votes != the digital oracle")
        direct = m["gpu"].run(m["x"][:400], specs["votes"]).cpu().numpy()
        require(np.array_equal(served[mid], direct),
                f"{mid}: served votes != direct run")
        print(f"  {mid}: card == CPU at B={batches}, == oracle at "
              f"B=100, served == direct for 400 requests")

    # ------------------------------------------- silicon mode (phase 5)
    silicon = silicon_phase(dev, b_main, batches, card, smi, models, cnns,
                            report, counted)
    print(json.dumps({"silicon": silicon}))

    # ------------------------------------------------- training (phase 6)
    train = train_phase(dev, smi, counted, quick=not on_card)
    print(json.dumps({"train": train}))

    # ------------------------------------------- the LM path (phase 7)
    lm = lm_phase(dev, smi, card, counted, quick=not on_card)
    print(json.dumps({"lm": lm}))
    lm_long = lm_long_phase(dev, smi, card, counted, quick=not on_card)
    print(json.dumps({"lm_long": lm_long}))

    # ---------------------------------------- LM training (phase 8)
    lm_train = lm_train_phase(dev, smi, card, counted, quick=not on_card)
    print(json.dumps({"lm_train": lm_train}))

    # -------------------------------------------- the mesh path (phase 9)
    mesh = mesh_phase(dev, smi, card, counted, served_models, served,
                      quick=not on_card)
    print(json.dumps({"mesh": mesh}))

    # --------------------------------------------- the dry-run (phase 10)
    dry = dryrun_phase(dev, smi, counted, quick=not on_card)
    print(json.dumps({"dryrun": dry}))

    # ---------------------------------------------- the examples (phase 11)
    ex = examples_phase(dev, smi, card, counted)
    print(json.dumps({"examples": ex}))

    # ------------------------------------- LFM2's prefill kernels (phase 12)
    lfm2 = lfm2_phase(dev, card, smi)
    print(json.dumps({"lfm2": lfm2}))

    # ------------------------------------------- input packing (phase 13)
    pack = pack_phase(dev, card, smi) if on_card else None
    print(json.dumps({"pack": pack}))

    # ------------------------------------------------------------ summary
    line = []
    for name, r in report.items():
        main = r["per_model"]["hg_cnn" if "conv" in name else "hg"]
        # kernel 2 is not on the classifier's main path (phase 3): its
        # paths are the LM CAM head (phase 7) and the public op, and its
        # headline row is the LM head's shape
        lm_path = name == "cam_vote"
        if lm_path:
            main = lm["kernels"][name][0]
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name],
            path=("LM CAM head (Engine decode, musicgen decode_step) + "
                  "kernels.ops.cam_vote" if lm_path
                  else "pipeline run + server"),
            launches=(lm["launches"][name] + op_launches[name] if lm_path
                      else launches[name]),
            main_path_launches=launches[name],
            silicon_launches=silicon["launches"][name],
            train_launches=train["launches"][name],
            lm_launches=lm["launches"][name], lm=lm["kernels"].get(name),
            # phase 7's long context: prefill at S = 32,768 and decode
            lm_long_launches=lm_long["launches"][name],
            lm_long=lm_long["kernels"].get(name),
            lm_train_launches=lm_train["launches"][name],
            # phase 9: fanout="spmd" (kernels 3/4) and the sharded LM
            # serving launcher (kernels 1/2), each counted from 0
            mesh_launches=sum(v[name] for v in mesh["launches"].values()),
            mesh=mesh["kernels"].get(name),
            # phase 10(b): the (1, 1) decode step under the dry-run's
            # counter, through the custom ops
            dryrun_launches=dry["launches"][name],
            # phase 11: the four examples, counted from 0
            examples_launches=ex["launches"][name],
            examples=ex["kernels"].get(name),
            sampled_ms=r.get("sampled", {}).get(
                "hg_cnn" if "conv" in name else "hg", {}).get("ms"),
            sampled=r.get("sampled"),
            equal=True, max_abs_err=max(
                v["max_abs_err"] for v in [*r["per_model"].values(),
                                           *lm["kernels"].get(name, []),
                                           *lm_long["kernels"].get(name,
                                                                   []),
                                           *ex["kernels"].get(name, [])]),
            ms=main["ms"], kernel_ms=main["ms"], call_ms=main["call_ms"],
            plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            bound_route=main["bound_route"],
            library_ms=main["library_ms"], shape=main["shape"],
            per_model=r["per_model"], card=smi,
        ))
    for name, rows in lfm2["kernels"].items():  # phase 12
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=None,
            path="LFM2 prefill (models.model.prefill)",
            launches=lfm2["launches"][name],
            main_path_launches=lfm2["launches"][name], equal=True,
            ms=rows[0]["ms"], kernel_ms=rows[0]["ms"],
            bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
            bound_route=rows[0]["bound_route"], shape=rows[0]["shape"],
            rows=rows, card=smi))
    for name in ("sign_words", "threshold_words") if pack else ():
        rows = [r for r in pack["rows"].values() if r["entry"] == name]
        line.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=None,
            path="pipeline run + server (CompiledPipeline._pack_input)",
            launches=rows[0]["launches_a_call"],
            main_path_launches=launches[name], equal=True,
            ms=rows[0]["ms"], kernel_ms=rows[0]["ms"],
            call_ms=rows[0]["call_ms"], plain_ms=rows[0]["plain_ms"],
            bound_ms=rows[0]["bound_ms"], bound_by="bytes",
            bound_route="bytes", shape=rows[0]["shape"], rows=rows,
            card=smi))
    return line


if __name__ == "__main__":
    sys.exit(main())
