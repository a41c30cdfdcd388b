"""Classification serving: the micro-batcher and `PicBnnServer` (port of
`repro.serve`, classifier half)."""
