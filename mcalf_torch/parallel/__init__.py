from mcalf_torch.parallel.fleet import (
    MeshEntry,
    fit_many,
    fit_stacked,
    init_distributed,
    make_mesh,
)
from mcalf_torch.parallel.results_io import fleet_summary, save_fleet_results

__all__ = [
    "MeshEntry",
    "fit_many",
    "fit_stacked",
    "init_distributed",
    "make_mesh",
    "fleet_summary",
    "save_fleet_results",
]
