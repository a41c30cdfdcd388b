"""Serving substrate: LM prefill/decode steps + the PiC-BNN
classification micro-batching server (serve/picbnn.py), port of
`repro.serve`."""

from repro_torch.serve.scheduler import (  # noqa: F401
    BatchingPolicy,
    LatencySummary,
    MicroBatcher,
    QueueFullError,
    latency_summary,
)
from repro_torch.serve.steps import (  # noqa: F401
    decode_step,
    greedy_sample,
    make_decode_step,
    make_prefill_step,
    prefill_step,
    temperature_sample,
)


def __getattr__(name):
    # the server and its records resolve lazily, as the reference's do,
    # so `from repro_torch.serve import BatchingPolicy` stays cheap
    if name in ("PicBnnServer", "ClassifyResult", "GroupHandle",
                "ServerStats", "ModelStats"):
        from repro_torch.serve import picbnn

        return getattr(picbnn, name)
    raise AttributeError(name)
