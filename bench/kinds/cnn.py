"""The repository's end-to-end binary CNN (`model` "cnn"): the same kind
as the paper's MLP (`kinds/mlp.py`), since `bench/model.py`,
`bench/reference/bnn.py` and `bench/roofline.py` read the configuration's
convs and input encoding themselves."""

from bench.kinds.mlp import (  # noqa: F401
    call, compare, control_call, make, output, step_work, units)
