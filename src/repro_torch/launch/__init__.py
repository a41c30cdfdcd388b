"""Launchers (port of `repro.launch`): mesh construction and the serving
and training entry points (`python -m repro_torch.launch.serve`,
`python -m repro_torch.launch.train`)."""

from repro_torch.launch.mesh import (  # noqa: F401
    make_host_mesh,
    make_production_mesh,
)
