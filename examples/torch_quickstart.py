"""Quickstart on the PyTorch/CUDA port: the paper's full pipeline in one
script (the counterpart of examples/quickstart.py).

1. Generate a synthetic MNIST-like dataset (10 classes, 28x28).
2. Train the paper's binary MLP (784 -> 128 -> 10) with sign-STE + BN.
3. Fold batch-norm into integer constants C_j (Eq. 3).
4. Deploy to CAM arrays (bank tiling) and run Algorithm 1: 33 output-layer
   executions with swept HD tolerance, majority vote (the fused MLP
   kernel), noiseless and under silicon PVT noise.
5. Report: software baseline vs end-to-end-binary accuracy, and the
   silicon performance model (Table II figures).
6. Serve the deployment (saved and loaded back) and the end-to-end-binary
   CNN (the fused conv kernel).

Runs on the CUDA card; `--device cpu` runs it on the CPU (the kernels'
plain versions).  `main(argv)` returns the numbers it prints (and, under
"made", the data, layers and deployments it made).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--fast]
      [--device cpu]
"""

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import bnn, ensemble, mapping
from repro_torch.core.device_model import SILICON, knob_schedule
from repro_torch.data.synthetic import MNIST_LIKE, binarize_images, make_dataset
from repro_torch.deploy import Deployment, deploy
from repro_torch.pipeline import resolve_device
from repro_torch.spec import InferenceSpec

ARGMAX = InferenceSpec(reduction="argmax")
SILICON_KEY = np.array([0, 7], np.uint32)  # the raw words of key 7


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA unless asked
    epochs = 3 if args.fast else 10
    n_train = 2000 if args.fast else 8000
    out, made = {"device": str(dev)}, {}
    t_start = time.perf_counter()

    print("=== 1. synthetic MNIST-like dataset ===")
    tx, ty, vx, vy = make_dataset(MNIST_LIKE, n_train=n_train, n_test=1000)
    txb, vxb = binarize_images(tx), binarize_images(vx)
    print(f"train {txb.shape}, test {vxb.shape}, inputs binarized to +-1")

    print("=== 2. train binary MLP 784->128->10 (sign-STE + BN) ===")
    cfg = bnn.MLPConfig(layer_sizes=(784, 128, 10), bias_cells=64)
    t0 = time.perf_counter()
    params = bnn.train_mlp(
        torch.Generator(device=dev).manual_seed(0), cfg, txb, ty,
        epochs=epochs, batch=128, lr=2e-3, verbose=True, device=dev,
    )
    out["train_s"] = time.perf_counter() - t0
    print(f"trained in {out['train_s']:.1f}s")
    sw = bnn.eval_accuracy(params, cfg, vxb, vy, topk=(1, 2))
    out["software_top1"], out["software_top2"] = sw["top1"], sw["top2"]
    print(f"software baseline: top1={sw['top1']:.4f} top2={sw['top2']:.4f}")

    print("=== 3. fold BN into C_j (Eq. 3) ===")
    folded = bnn.fold(params, cfg)
    for i, f in enumerate(folded):
        print(f"layer {i}: W{f.weights_pm1.shape}, C_j in "
              f"[{f.c.min()}, {f.c.max()}]")

    print("=== 4. map to CAM banks ===")
    mapped = [mapping.map_layer(l, cfg.bias_cells) for l in folded[:-1]]
    for i, m in enumerate(mapped):
        print(f"layer {i}: plan {m.plan}")
    ecfg = ensemble.EnsembleConfig()
    head = ensemble.build_head(folded[-1], ecfg)
    knobs, achieved = knob_schedule(len(ecfg.thresholds), 64)
    out["knob0"] = knobs[0].round(3).tolist()
    out["achieved0"] = float(achieved[0])
    print(f"output head: {head.n_classes} class rows, "
          f"{len(ecfg.thresholds)} passes; first knob settings "
          f"(V_ref,V_eval,V_st)={out['knob0']} -> HD "
          f"{out['achieved0']:.1f}")

    print("=== 5. Algorithm 1 inference (deployment + InferenceSpec) ===")
    # deployment artifact: folded layers + ensemble config bundled; the
    # fused pipeline (all layers + the 33-threshold vote in one kernel
    # launch a batch block) compiles lazily per device
    dep = deploy(folded, config=cfg, ens_cfg=ecfg, device=dev)
    impl = "cuda kernel" if dev.type == "cuda" else "plain"
    t0 = time.perf_counter()
    pred = dep.run(vxb, ARGMAX).cpu()
    dt = time.perf_counter() - t0
    acc = float((pred.numpy() == vy).mean())
    out["binary_top1"], out["kinf_per_s_incl_compile"] = acc, \
        len(vy) / dt / 1e3
    print(f"  end-to-end-binary top1 [fused pipeline/{impl}]: "
          f"{acc:.4f}  ({out['kinf_per_s_incl_compile']:.1f}K inf/s incl. "
          f"compile)")
    # silicon PVT noise: the same fused kernel with sampled thresholds;
    # the LLN claim is 33 noisy passes ~ noiseless accuracy
    dep_si = deploy(folded, config=cfg, ens_cfg=ecfg, noise=SILICON,
                    device=dev)
    pred_si = dep_si.run(vxb, InferenceSpec(noise="batch",
                                            reduction="argmax"),
                         key=torch.Generator(device=dev).manual_seed(7))
    acc_si = float((pred_si.cpu().numpy() == vy).mean())
    out["silicon_top1"] = acc_si
    print(f"  end-to-end-binary top1 [silicon PVT noise, fused]: "
          f"{acc_si:.4f}  (delta vs noiseless {100 * (acc - acc_si):+.2f} "
          f"points — LLN over {ecfg.n_passes} passes)")

    print("=== 6. silicon performance model (Table II) ===")
    plans = [m.plan for m in mapped] + [
        mapping.plan_layer(10, 128, cfg.bias_cells)
    ]
    cost = mapping.model_inference_cost(plans, len(ecfg.thresholds))
    out["table2_cycles"] = cost.cycles
    out["table2_inf_per_s"] = cost.inferences_per_s
    out["table2_inf_per_s_per_w"] = 1.0 / cost.energy_j
    print(f"  {cost.cycles} cycles/inference @25MHz -> "
          f"{cost.inferences_per_s/1e3:.0f}K inf/s "
          f"(paper: 560K); {1.0/cost.energy_j/1e6:.0f}M inf/s/W "
          f"(paper: 703M)")

    print("=== 7. serving: register deployments, even from disk ===")
    # both deployments behind one submit() API; silicon requests carry a
    # per-request key, so served draws are reproducible bit for bit.  The
    # noiseless model round-trips through Deployment.save/load, the path
    # a production server takes when registering models from a
    # checkpoint directory.
    from repro_torch.serve.picbnn import BatchingPolicy, PicBnnServer

    srv = PicBnnServer(BatchingPolicy(max_batch=256, max_wait_us=500.0),
                       devices=[dev])
    with tempfile.TemporaryDirectory() as ckpt_dir:
        dep.save(ckpt_dir)  # manifest + bit-packed weights
        loaded = Deployment.load(ckpt_dir, device=dev)
        srv.register("mnist", loaded)
        srv.register("mnist-si", dep_si)
        srv.warmup()  # every bucket compiled: no first-request spike
        with srv:
            handles = [srv.submit("mnist", vxb[i]) for i in range(512)]
            h_si = srv.submit("mnist-si", vxb[0], key=SILICON_KEY)
            served = [h.wait() for h in handles]
            out["served_pred0"], out["direct_pred0"] = served[0], \
                int(pred[0])
            out["silicon_pred0"] = h_si.wait()
            print(f"  served pred[0]={served[0]} (direct: {int(pred[0])}"
                  f"), silicon pred[0]={out['silicon_pred0']}")
    print("  " + srv.stats().summary().replace("\n", "\n  "))

    print("=== 8. end-to-end-binary CNN workload ===")
    # the input layer is binary too: raw [0,1] pixels pass through a
    # thermometer encoding inside the fused conv kernel's pipeline (the
    # paper's end-to-end claim, conv edition)
    from repro_torch.configs.paper_cnn import MNIST_CNN, deploy_cnn
    from repro_torch.core import convnet

    cnn_epochs = 2 if args.fast else 6
    t0 = time.perf_counter()
    cnn_params = convnet.train_cnn(
        torch.Generator(device=dev).manual_seed(1), MNIST_CNN, tx, ty,
        epochs=cnn_epochs, device=dev,
    )
    out["cnn_train_s"] = time.perf_counter() - t0
    # trained params + config in, deployment out (the fold runs inside)
    cnn_dep = deploy_cnn(MNIST_CNN, cnn_params, device=dev)
    acc_sw = convnet.eval_cnn_accuracy(cnn_params, MNIST_CNN, vx, vy)["top1"]
    cnn_pred = cnn_dep.run(vx, ARGMAX).cpu()
    acc_cnn = float((cnn_pred.numpy() == vy).mean())
    cnn_cost = convnet.cnn_inference_cost(MNIST_CNN)
    out["cnn_software_top1"], out["cnn_binary_top1"] = acc_sw, acc_cnn
    out["cnn_silicon_inf_per_s"] = cnn_cost.inferences_per_s
    print("  conv(3x3x32,s2) x2 -> FC128 -> 10-row CAM head, "
          "thermometer-8 input")
    print(f"  software top1 {acc_sw:.4f} vs deployed Algorithm-1 "
          f"{acc_cnn:.4f}; silicon equivalent "
          f"{cnn_cost.inferences_per_s/1e3:.1f}K inf/s")
    cnn_srv = PicBnnServer(BatchingPolicy(max_batch=128, max_wait_us=500.0),
                           devices=[dev])
    cnn_srv.register("cnn-mnist", cnn_dep, silicon_cost=cnn_cost)
    with cnn_srv:
        h = cnn_srv.submit("cnn-mnist", vx[0])  # raw [0,1] pixels
        direct = int(cnn_dep.run(vx[:1], ARGMAX)[0])
        out["served_cnn_pred0"], out["direct_cnn_pred0"] = h.wait(), direct
        print(f"  served CNN pred[0]={out['served_cnn_pred0']} "
              f"(direct: {direct})")
    out["wall_s"] = time.perf_counter() - t_start
    made.update(folded=folded, cfg=cfg, ens_cfg=ecfg, plans=plans, dep=dep,
                vxb=vxb, vx=vx, vy=vy, pred=pred, served=np.asarray(served),
                cnn_dep=cnn_dep, cnn_pred=cnn_pred)
    return {**out, "made": made}


if __name__ == "__main__":
    main()
