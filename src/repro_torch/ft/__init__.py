"""Fault tolerance (port of `repro.ft`): supervisor (checkpoint/restart +
straggler monitor), elastic moves, failure injection for tests."""

from repro_torch.ft.supervisor import Supervisor, SupervisorConfig, StragglerMonitor  # noqa: F401
from repro_torch.ft.elastic import reshard_state, rescale_microbatches  # noqa: F401
from repro_torch.ft.failures import InjectedFailure, failing_step, slow_step  # noqa: F401
