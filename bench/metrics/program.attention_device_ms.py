"""The attention sublayers, read from the program's own span
`lm.attention` (`bench/program_trace.py`): the q, k, v projections, the
QK norms and RoPE, the chunked float32 online softmax and the output
projection of every attention layer; the device time of the operations
launched with it the innermost span open, in milliseconds a call.
Nothing to read where the program opens no such span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "lm.attention")
