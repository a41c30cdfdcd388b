"""The dropless MoE's routing, read from the program's own span
`moe.route` (`repro_torch.obs`; `bench/program_trace.py`): the router's
float32 product and sigmoid, the biased top-k, the sort by expert and
the offsets, in every MoE layer; the device time of the operations
launched with it the innermost span open, in milliseconds a call.
Nothing to read where the program opens no such span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "moe.route")
