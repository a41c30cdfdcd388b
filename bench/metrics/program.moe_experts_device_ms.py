"""The dropless MoE's experts, read from the program's own span
`moe.experts` (`bench/program_trace.py`): the sign and pack of the
sorted slots, kernel 1's grouped launches (gate, up, down), the scaling
and SwiGLU, in every MoE layer; the device time of the operations
launched with it the innermost span open, in milliseconds a call.
Nothing to read where the program opens no such span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "moe.experts")
