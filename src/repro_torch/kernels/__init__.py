"""Hand-written CUDA kernels for the Hopper card (sources in `csrc/`),
each beside its plain PyTorch version (port of `repro.kernels`)."""
