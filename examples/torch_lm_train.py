"""End-to-end LM training driver on the PyTorch/CUDA port (the
counterpart of examples/lm_train.py).

Trains a ~100M-parameter llama-style model for a few hundred steps on
synthetic token data through the full stack: config -> AdamW train step
-> fault-tolerant supervisor with async checkpointing
(`repro_torch.launch.train`).

The default is a scaled-down preset; pass --preset 100m for the full
100M x 300-step run (the same code path).  Checkpoints go to --ckpt-dir,
by default a temporary directory removed at the end (a directory that
holds checkpoints resumes from its last one).

Runs on the CUDA card; `--device cpu` runs it on the CPU.  `main(argv)`
returns the losses and step times.

Run:  PYTHONPATH=src python examples/torch_lm_train.py
      [--preset tiny|100m] [--ckpt-dir DIR] [--device cpu]
"""

import argparse
import tempfile

from repro_torch.launch import train as T
from repro_torch.pipeline import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # raises without CUDA unless asked
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        if args.preset == "100m":
            argv = [
                "--arch", "custom-100m", "--steps", "300", "--batch", "8",
                "--seq", "512", "--ckpt-dir", ckpt_dir,
                "--ckpt-every", "50", "--log-every", "10",
            ]
        else:
            argv = [
                "--arch", "llama3.2-1b+smoke", "--steps", "60", "--batch",
                "8", "--seq", "64", "--ckpt-dir", ckpt_dir,
                "--ckpt-every", "20", "--log-every", "10", "--lr", "1e-2",
            ]
        res = T.run(argv + ["--device", str(dev)])
    losses = res["losses"]
    assert len(losses) >= 60 or args.preset == "100m"
    return {"device": str(dev), "preset": args.preset, "steps": len(losses),
            "losses": losses, "first_loss": losses[0],
            "last_loss": losses[-1],
            "ms_per_step": 1e3 * sum(res["step_s"]) / len(res["step_s"])}


if __name__ == "__main__":
    main()
