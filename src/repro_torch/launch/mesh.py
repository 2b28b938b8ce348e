"""Production mesh entry point (re-export; see repro_torch.distributed.mesh)."""
from repro_torch.distributed.mesh import (axis_size, data_axes, make_mesh,  # noqa: F401
                                          make_production_mesh)
