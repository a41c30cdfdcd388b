"""Bit packing, folded binary layers, CAM arrays and the Algorithm-1
ensemble head (port of `repro.core`, inference half)."""
