"""Samplers, read from the program's own span `sampler` (opened inside
`SearchPhysics.sample_keyed` and `.sample`; `bench/program_trace.py`):
the device time of the operations launched inside it, in milliseconds a
call.  The twin of `sampler.device_ms`, which wraps `sample_keyed` from
outside.  Nothing to read where the program draws no thresholds or opens
no such span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "sampler")
