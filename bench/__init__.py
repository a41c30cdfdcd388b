"""The benchmark of `repro_torch`, the PyTorch and CUDA port of PiC-BNN on
an NVIDIA H100: see `bench/README.md` and `BENCHMARK.json`."""
