"""The HD-once routes' head distances, read from the program's own span
`head_distances` (`bench/program_trace.py`): kernel 4's stage entry for
a CNN, then kernel 1 per FC layer and for the head, with the sign and
repack between them; the device time of the operations launched inside
it, in milliseconds a call.  Nothing to read where the spec takes the
fused votes (noise "off") or the program opens no such span."""

from bench import program_trace


def read(ctx):
    return program_trace.device_ms(ctx, "head_distances")
