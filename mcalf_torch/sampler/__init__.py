from mcalf_torch.sampler.clusters import (
    ClusterReport,
    assign_clusters,
    posterior_cluster_report,
)
from mcalf_torch.sampler.diagnostics import RankDiagnostic, insertion_rank_test
from mcalf_torch.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    canonicalize_u,
    finalize,
    init_state,
    is_done,
    nested_sample,
    nsstate_from_numpy,
    nsstate_to_numpy,
    run_steps,
    slice_chains,
)
from mcalf_torch.sampler.results import equal_weights_matrix, resample_equal

__all__ = [
    "NSConfig",
    "NSResults",
    "NSState",
    "canonicalize_u",
    "finalize",
    "init_state",
    "is_done",
    "nested_sample",
    "nsstate_from_numpy",
    "nsstate_to_numpy",
    "run_steps",
    "slice_chains",
    "equal_weights_matrix",
    "resample_equal",
    "RankDiagnostic",
    "insertion_rank_test",
    "ClusterReport",
    "assign_clusters",
    "posterior_cluster_report",
]
