"""Two gloo ranks on the CPU, run by tests/test_torch_sharding.py in a
subprocess: the port's sharded LM serving, MoE dispatch groups and train
step against the unsharded port on the same weights, on (data, model)
meshes of (1, 2) and (2, 1).  Rank 0 writes the MoE output to
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
    for arch in (SERVE_ARCH, "llama3.2-1b+smoke+binary-ffn"):
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


def _train(mesh) -> dict:
    from repro_torch import configs
    from repro_torch.data.tokens import DataConfig, synthetic_stream
    from repro_torch.ft import reshard_state, state_shardings
    from repro_torch.sharding import TRAIN_RULES, use_rules
    from repro_torch.train import TrainConfig, init_train_state, train_step
    from repro_torch.train.optimizer import OptimizerConfig

    cfg = configs.get_config("llama3.2-1b+smoke")
    # lr 3e-4 from the first step: a skipped or doubled update is ~lr off
    tcfg = TrainConfig(opt=OptimizerConfig(warmup_steps=0))
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
    return {"train/loss_err": abs(float(_full(m1["loss"]))
                                  - float(m0["loss"])),
            "train/update_err": err, "train/update_max": moved,
            "train/lr": tcfg.opt.lr, "train/opt_err": err_m,
            "train/placements": str(
                s1["params"].blocks[0].sub0.attn.wq.placements)}


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
                         **_bitlinear_unaligned(mesh)}.items():
                res[f"{tag}/{k}"] = v
            if shape == (2, 1):
                res.update(_moe(mesh, out_dir))
        if rank == 0:
            print("SHARDED-OK " + json.dumps(res), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(worker, args=(int(sys.argv[1]), sys.argv[2]), nprocs=2)
