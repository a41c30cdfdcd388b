"""Two gloo ranks on the CPU, run by tests/test_torch_sharding.py in a
subprocess: the port's sharded LM serving (a Mamba model too), MoE
dispatch groups and train step (a Mamba model too) against the
unsharded port on the same weights, on (data, model)
meshes of (1, 2) and (2, 1) (the step also for an MoE model over two
microbatches; the loss's and every parameter's gradients; the
embedding's two gathers; a decode over a sequence-split cache), and the train launcher with --ckpt-dir
(saved, restarted, continued) against an uninterrupted run, counting
the checkpoint writes of each rank.  Rank 0 writes the MoE output to
`<out>/moe_port.npz` and prints one line, "SHARDED-OK <json>", with every
measured difference.

    python tests/_torch_sharded_worker.py <port> <out dir>
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = ((1, 2), (2, 1))
SERVE_ARCH = "llama3.2-1b+smoke+binary-ffn+cam-head"


def _full(t):
    from repro_torch.sharding.rules import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def _no_fallback(monkey):
    """Make the float ±1 forms raise while a sharded serving run lasts."""
    from repro_torch.models import binary_lm

    def refuse(*a, **k):
        raise AssertionError("a DTensor serving path took a float ±1 form")

    for name in ("_bit_matmul", "cam_head_logits_pm1"):
        monkey.append((binary_lm, name, getattr(binary_lm, name)))
        setattr(binary_lm, name, refuse)


def _serve(mesh) -> dict:
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.sharding import SERVE_RULES, use_rules

    rules = SERVE_RULES.resolve(mesh)
    out = {}
    gen = torch.Generator().manual_seed(1)
    for arch in (SERVE_ARCH, "llama3.2-1b+smoke+binary-ffn",
                 "falcon-mamba-7b+smoke"):
        cfg = configs.get_config(arch)
        tok = torch.randint(1, cfg.vocab_size, (4, 8), generator=gen)
        nxt = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen)
        p0 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        p1 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        M.shard_params(p1, mesh, rules)
        lg0, c0 = M.prefill(p0, cfg, tokens=tok, max_len=12)
        dec0, _ = M.decode(p0, cfg, c0, nxt, 8)
        undo = []
        _no_fallback(undo)
        try:
            with use_rules(rules, mesh):
                lg1, c1 = M.prefill(p1, cfg, tokens=tok, max_len=12)
                dec1, _ = M.decode(p1, cfg, c1, nxt, 8)
                out[f"{arch}/votes_placements"] = str(dec1.placements)
                lg1, dec1 = _full(lg1), _full(dec1)
            if cfg.cam_head:
                reqs = [Request(uid=i, prompt=np.arange(1 + i, 7 + 2 * i,
                                                        dtype=np.int32),
                                max_new_tokens=5) for i in range(3)]
                ecfg = EngineConfig(max_batch=4, eos_id=-1)
                t0 = [r.tokens for r in Engine(cfg, p0, ecfg,
                                               "cpu").generate(reqs)]
                with use_rules(rules, mesh):
                    t1 = [r.tokens for r in Engine(cfg, p1, ecfg,
                                                   "cpu").generate(reqs)]
                out[f"{arch}/tokens_equal"] = t0 == t1
        finally:
            for mod, name, fn in undo:
                setattr(mod, name, fn)
        out[f"{arch}/prefill_err"] = float((lg1 - lg0).abs().max())
        if cfg.cam_head:
            out[f"{arch}/votes_equal"] = bool(torch.equal(dec1, dec0))
        else:
            out[f"{arch}/decode_err"] = float((dec1 - dec0).abs().max())
    return out


def _bitlinear_unaligned(mesh) -> dict:
    """A BitLinear FFN whose hidden dim (96) splits over 'model' into
    shards of 48 bits, not a whole number of 32-bit words: each shard is
    packed on its own, so the result stays the unsharded one's."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.rules import distribute

    cfg = dataclasses.replace(
        configs.get_config("llama3.2-1b+smoke+binary-ffn"), d_ff=96)
    rules = SERVE_RULES.resolve(mesh)
    gen = torch.Generator().manual_seed(3)
    p = L.MLP(cfg, "cpu")
    p.draw(gen)
    x = torch.randn((4, 8, cfg.d_model), generator=gen)
    with torch.no_grad():
        want = L.mlp(p, cfg, x)
        for name, ax in L.mlp_param_axes(cfg).items():
            setattr(p, name, torch.nn.Parameter(distribute(
                getattr(p, name).detach(), rules.spec(*ax), mesh)))
        with use_rules(rules, mesh):
            got = _full(L.mlp(p, cfg, distribute(
                x, rules.spec("batch", "seq", "embed"), mesh)))
    return {"bitlinear_k48/placements": str(p.w_down.placements),
            "bitlinear_k48/err": float((got - want).abs().max())}


def _train(mesh, arch="llama3.2-1b+smoke", microbatches=1,
           prefix="train", **cut) -> dict:
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.ft import reshard_state, state_shardings
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.train import TrainConfig, init_train_state, train_step
    from repro_torch.train.optimizer import OptimizerConfig

    import dataclasses

    cfg = dataclasses.replace(configs.get_config(arch), **cut)
    # lr 3e-4 from the first step: a skipped or doubled update is ~lr off
    tcfg = TrainConfig(opt=OptimizerConfig(warmup_steps=0),
                       microbatches=microbatches)
    rules = TRAIN_RULES.resolve(mesh)
    batch = next(synthetic_stream(DataConfig(batch=4, seq_len=16,
                                             vocab_size=cfg.vocab_size)))
    s0 = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    s1 = init_train_state(cfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    s1 = reshard_state(s1, state_shardings(cfg, mesh, rules, s1))
    before = {k: p.detach().clone()
              for k, p in s0["params"].named_parameters()}
    s0, m0 = train_step(cfg, tcfg, s0, batch)
    with use_rules(rules, mesh):
        s1, m1 = train_step(cfg, tcfg, s1, batch)
    # each side's update (after - before), the sharded one against the
    # unsharded one
    d0 = {k: p.detach() - before[k]
          for k, p in s0["params"].named_parameters()}
    err = max(float((_full(p).detach() - before[k] - d0[k]).abs().max())
              for k, p in s1["params"].named_parameters())
    moved = max(float(d.abs().max()) for d in d0.values())
    err_m = max(float((_full(s1["opt"][t][k]) - v).abs().max())
                for t in ("m", "v", "master")
                for k, v in s0["opt"][t].items())
    return {f"{prefix}/loss_err": abs(float(_full(m1["loss"]))
                                      - float(m0["loss"])),
            f"{prefix}/update_err": err, f"{prefix}/update_max": moved,
            f"{prefix}/lr": tcfg.opt.lr, f"{prefix}/opt_err": err_m,
            f"{prefix}/placements": str(_first_weight(s1["params"])
                                        .placements)}


def _loss_grads(mesh) -> dict:
    """llama3.2-1b+smoke's loss and every parameter's gradient under
    TRAIN_RULES (the vocab-split gold logit and embedding on each rank's
    rows) against the unsharded port; the embedding's local output."""
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.models import model as M
    from repro_torch.sharding import TRAIN_RULES, use_rules

    cfg = configs.get_config("llama3.2-1b+smoke")
    rules = TRAIN_RULES.resolve(mesh)
    batch = {k: torch.as_tensor(v) for k, v in next(synthetic_stream(
        DataConfig(batch=4, seq_len=16,
                   vocab_size=cfg.vocab_size))).items()}
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p1 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    M.shard_params(p1, mesh, rules)
    loss0, _ = M.loss_fn(p0, cfg, batch)
    g0 = dict(zip([n for n, _ in p0.named_parameters()],
                  torch.autograd.grad(loss0, list(p0.parameters()))))
    with use_rules(rules, mesh):
        emb = M._embedding(p1, batch["tokens"])
        loss1, _ = M.loss_fn(p1, cfg, batch)
        names = [n for n, _ in p1.named_parameters()]
        with M._sharded(p1):
            g1 = torch.autograd.grad(loss1, list(p1.parameters()))
    grad_err = max(float((_full(g) - g0[n]).abs().max())
                   for n, g in zip(names, g1))
    return {"loss_grads/loss_err": abs(float(_full(loss1)) - float(loss0)),
            "loss_grads/grad_err": grad_err,
            "loss_grads/grad_max": max(float(g.abs().max())
                                       for g in g0.values()),
            "loss_grads/embed_local": list(emb.to_local().shape),
            "loss_grads/embed_placements": str(emb.placements),
            "loss_grads/vocab_placements": str(p1.embed.placements)}


def _embed_forms(mesh) -> dict:
    """llama3.2-1b+smoke's embedding under TRAIN_RULES at 4 x 16 tokens
    (fewer than dp times the table's local rows: on a data split the
    tokens are gathered) and 4 x 256 (the table's columns gathered): the
    output and the table's gradient against the unsharded lookup's, and
    the output's local shape."""
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sharding import TRAIN_RULES, use_rules

    cfg = configs.get_config("llama3.2-1b+smoke")
    rules = TRAIN_RULES.resolve(mesh)
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p1 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    M.shard_params(p1, mesh, rules)
    gen, res = torch.Generator().manual_seed(3), {}
    for s in (16, 256):
        tok = torch.randint(0, cfg.vocab_size, (4, s), generator=gen)
        w = torch.randn(4, s, cfg.d_model, generator=gen)
        y0 = F.embedding(tok, p0.embed)
        g0, = torch.autograd.grad((y0 * w).sum(), [p0.embed])
        with use_rules(rules, mesh):
            y1 = M._embedding(p1, tok)
            with M._sharded(p1):
                g1, = torch.autograd.grad((y1.full_tensor() * w).sum(),
                                          [p1.embed])
        res[f"embed_forms/{s}/err"] = float((_full(y1) - y0).abs().max())
        res[f"embed_forms/{s}/grad_err"] = float((_full(g1) - g0).abs()
                                                 .max())
        res[f"embed_forms/{s}/local"] = list(y1.to_local().shape)
    return res


def _seqcache(mesh) -> dict:
    """stablelm-3b+smoke under SERVE_SEQCACHE_RULES (the cache's sequence
    split over 'model'): prefill and three decode steps against the
    unsharded port."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.sharding import SERVE_SEQCACHE_RULES, use_rules

    cfg = configs.get_config("stablelm-3b+smoke")
    rules = SERVE_SEQCACHE_RULES.resolve(mesh)
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(1, cfg.vocab_size, (4, 8), generator=gen)
    nxt = torch.randint(1, cfg.vocab_size, (3, 4, 1), generator=gen)
    p0 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p1 = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    M.shard_params(p1, mesh, rules)
    with torch.no_grad():
        lg0, c0 = M.prefill(p0, cfg, tokens=tok, max_len=12)
        dec0 = [M.decode(p0, cfg, c0, nxt[t], 8 + t)[0] for t in range(3)]
        with use_rules(rules, mesh):
            lg1, c1 = M.prefill(p1, cfg, tokens=tok, max_len=12)
            dec1 = [_full(M.decode(p1, cfg, c1, nxt[t], 8 + t)[0])
                    for t in range(3)]
            k1 = c1[0]["sub0"]["k"]
    return {"seqcache/prefill_err": float((_full(lg1) - lg0).abs().max()),
            "seqcache/decode_err": max(float((a - b).abs().max())
                                       for a, b in zip(dec1, dec0)),
            "seqcache/cache_err": float((_full(k1) - c0[0]["sub0"]["k"])
                                        .abs().max()),
            "seqcache/cache_placements": str(k1.placements)}


def _first_weight(params):
    """Block 0's first projection: attention's wq, or Mamba's in_proj."""
    sub = params.blocks[0].sub0
    return sub.attn.wq if hasattr(sub, "attn") else sub.mamba.in_proj


def _moe(mesh, out_dir) -> dict:
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.sharding import SERVE_RULES, use_rules
    from repro_torch.sharding.rules import distribute, logical_axis_size

    cfg = configs.get_config("mixtral-8x7b+smoke")
    rules = SERVE_RULES.resolve(mesh)
    data = np.load(f"{out_dir}/moe_in.npz")
    p = L.MoE(cfg, "cpu")
    axes = L.moe_param_axes(cfg)
    with torch.no_grad():
        for name, ax in axes.items():
            w = torch.from_numpy(data[name])
            setattr(p, name, torch.nn.Parameter(
                distribute(w, rules.spec(*ax), mesh)))
    h = distribute(torch.from_numpy(data["h"]),
                   rules.spec("batch", "seq", "embed"), mesh)
    with use_rules(rules, mesh), torch.no_grad():
        g = logical_axis_size("batch")
        aux = {}
        y = _full(L.moe(p, cfg, h, aux=aux))
    if dist.get_rank() == 0:
        np.savez(f"{out_dir}/moe_port.npz", y=y.numpy(),
                 aux=float(_full(aux["moe_aux"])))
    return {"moe/groups": g}


def _ckpt(mesh, out_dir) -> dict:
    """`launch.train --ckpt-dir` over both ranks: 2 steps saved at step
    2, then a restart that restores it and continues to step 4, against
    4 uninterrupted steps; each rank's writes counted."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import train

    mp = mesh.shape[1]
    root = f"{out_dir}/ckpt_{mesh.shape[0]}x{mp}"
    args = ["--arch", "llama3.2-1b+smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--log-every", "1000", "--model-parallel", str(mp)]
    want = train.run(args + ["--steps", "4"])["state"]
    writes, write = [], ckpt._write_step

    def counted(root, step, *a):
        writes.append(step)
        return write(root, step, *a)

    ckpt._write_step = counted
    try:
        saved = ["--ckpt-dir", root, "--ckpt-every", "2"]
        train.run(args + ["--steps", "2"] + saved)
        got = train.run(args + ["--steps", "4"] + saved)["state"]
    finally:
        ckpt._write_step = write
    equal = all(torch.equal(_full(a).detach(), _full(b).detach())
                for (_, a), (_, b) in zip(ckpt.leaf_paths(want),
                                          ckpt.leaf_paths(got)))
    by_rank = [None] * dist.get_world_size()
    dist.all_gather_object(by_rank, writes)
    # the leaves each rank holds for a save: all on the writer, none else
    held = [None] * dist.get_world_size()
    dist.all_gather_object(held, [len(ckpt._arrays(got)),
                                  len(ckpt._arrays(got, copy=True))])
    import os

    return {"ckpt/equal": equal, "ckpt/writes_by_rank": by_rank,
            "ckpt/held_by_rank": held,
            "ckpt/n_leaves": len(ckpt.leaf_paths(got)),
            "ckpt/dirs": sorted(os.listdir(root)),
            "ckpt/placements": str(
                got["params"].blocks[0].sub0.attn.wq.placements)}


def worker(rank: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        from repro_torch.launch.mesh import make_mesh

        res = {}
        for shape in MESHES:
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            tag = "x".join(map(str, shape))
            for k, v in {**_serve(mesh), **_train(mesh),
                         # the MoE's aux loss and two microbatches; a
                         # capacity that drops no token, so the dispatch
                         # groups of a data split route as one group does
                         **_train(mesh, "mixtral-8x7b+smoke", 2,
                                  "train_moe_mb2", capacity_factor=8.0),
                         # the Mamba conv and scan on each rank's shards
                         **_train(mesh, "falcon-mamba-7b+smoke", 1,
                                  "train_mamba"),
                         **_bitlinear_unaligned(mesh),
                         **_loss_grads(mesh), **_embed_forms(mesh),
                         **_seqcache(mesh),
                         **_ckpt(mesh, out_dir)}.items():
                res[f"{tag}/{k}"] = v
            if shape == (2, 1):
                res.update(_moe(mesh, out_dir))
        if rank == 0:
            print("SHARDED-OK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
