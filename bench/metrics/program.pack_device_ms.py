"""Input packing, read from the program's own span `run.pack`
(`repro_torch.obs`; `bench/program_trace.py`): the device time of the
operations launched with `run.pack` the innermost span open, in
milliseconds a call.  The twin of `pack.device_ms`, which wraps the
same call from outside.  Nothing to read where the program opens no such
span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "run.pack")
