"""Fault-tolerance demo on the PyTorch/CUDA port (the counterpart of
examples/ft_demo.py).

Trains a small LM under the supervisor while injecting two simulated node
failures and one straggler episode; shows checkpoint/restart recovery,
straggler detection, and that the final parameters match a failure-free
run (deterministic replay).

Runs on the CUDA card; `--device cpu` runs it on the CPU.  `main(argv)`
returns the numbers it prints.

Run:  PYTHONPATH=src python examples/torch_ft_demo.py [--device cpu]
"""

import argparse
import shutil
import tempfile
from pathlib import Path

import torch

from repro_torch import configs
from repro_torch.data.tokens import DataConfig, synthetic_stream
from repro_torch.ft import Supervisor, SupervisorConfig, failing_step, slow_step
from repro_torch.pipeline import resolve_device
from repro_torch.train import TrainConfig, init_train_state, make_train_step

STEPS, FAIL_AT, SLOW_AT, DELAY_S = 40, (13, 27), range(31, 36), 0.8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA unless asked
    cfg = configs.get_config("llama3.2-1b+smoke")
    tcfg = TrainConfig()

    def make_data(start):
        dcfg = DataConfig(batch=4, seq_len=32, vocab_size=cfg.vocab_size)
        it = synthetic_stream(dcfg)
        for _ in range(start):
            next(it)
        return it

    def run(faulty: bool, tag: str):
        # the step updates the state in place: each run starts from its
        # own copy of the same initial state
        state = init_train_state(cfg, tcfg, torch.Generator(device=dev)
                                 .manual_seed(0), device=dev)
        step = make_train_step(cfg, tcfg)
        if faulty:
            step = slow_step(failing_step(step, fail_at=FAIL_AT),
                             slow_at=SLOW_AT, delay_s=DELAY_S)
        d = Path(tempfile.mkdtemp(prefix=f"ftdemo_{tag}_"))
        alerts = []
        sup = Supervisor(
            SupervisorConfig(ckpt_dir=d, ckpt_every=10, backoff_s=0.0,
                             straggler_z=3.0, straggler_patience=2),
            step, make_data, state, on_straggler=alerts.append,
        )
        try:
            final = sup.run(state, STEPS)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        losses = [h["loss"] for h in sup.history]
        return final, losses, sup.restarts, alerts

    print(f"=== failure-free reference run ({STEPS} steps) ===")
    clean_final, clean_losses, _, _ = run(False, "clean")
    print(f"final loss {clean_losses[-1]:.4f}")

    print(f"\n=== faulted run: failures @ step {FAIL_AT[0]} & {FAIL_AT[1]}, "
          f"straggler @ {SLOW_AT[0]}-{SLOW_AT[-1]} ===")
    fault_final, fault_losses, restarts, alerts = run(True, "flaky")
    print(f"final loss {fault_losses[-1]:.4f}  restarts={restarts}  "
          f"straggler alerts={len(alerts)}")
    for a in alerts[:2]:
        print(f"  alert: step {a['step']} took {a['dt']:.2f}s "
              f"(mean {a['mean']:.2f}s, z={a['z']:.1f})")

    # every parameter, each to the reference example's 1e-5
    pairs = [(a.detach(), b.detach()) for a, b in zip(
        clean_final["params"].parameters(),
        fault_final["params"].parameters())]
    same = all(torch.allclose(a, b, rtol=0.0, atol=1e-5) for a, b in pairs)
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    print(f"\nfinal params identical to failure-free run: {same} "
          f"(checkpoint/restart + deterministic replay)")
    return {"device": str(dev), "steps": STEPS,
            "clean_final_loss": clean_losses[-1],
            "final_loss": fault_losses[-1], "restarts": restarts,
            "straggler_alerts": len(alerts),
            "alert_steps": [a["step"] for a in alerts],
            "params_identical": same, "max_param_diff": diff}


if __name__ == "__main__":
    main()
