"""The gated short-conv sublayers, read from the program's own span
`lm.short_conv` (`bench/program_trace.py`): in_proj, the gates, the
causal depthwise conv and out_proj of every conv layer; the device time
of the operations launched with it the innermost span open, in
milliseconds a call.  Nothing to read where the program opens no such
span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "lm.short_conv")
