from mcalf_torch.parallel.fleet import fit_many, fit_stacked, make_mesh
from mcalf_torch.parallel.results_io import fleet_summary, save_fleet_results

__all__ = [
    "fit_many",
    "fit_stacked",
    "make_mesh",
    "fleet_summary",
    "save_fleet_results",
]
