from mcalf_torch.sampler.clusters import (
    ClusterReport,
    assign_clusters,
    posterior_cluster_report,
)
from mcalf_torch.sampler.diagnostics import RankDiagnostic, insertion_rank_test
from mcalf_torch.sampler.dynamic import (
    DynamicResults,
    dynamic_sample,
    posterior_ess,
)
from mcalf_torch.sampler.merge import MergedRun, merge_results, nlive_of_logl
from mcalf_torch.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    canonicalize_u,
    finalize,
    init_state,
    is_done,
    nested_sample,
    nested_sample_stacked,
    nsstate_from_numpy,
    nsstate_to_numpy,
    run_steps,
    slice_chains,
    stack_results,
    stack_states,
    unstack_results,
    unstack_states,
)
from mcalf_torch.sampler.repeats import (
    ConvergedRun,
    LadderRung,
    converged_sample,
)
from mcalf_torch.sampler.results import (
    equal_weights_matrix,
    posterior_stats,
    resample_equal,
)

__all__ = [
    "NSConfig",
    "NSResults",
    "NSState",
    "canonicalize_u",
    "finalize",
    "init_state",
    "is_done",
    "nested_sample",
    "nested_sample_stacked",
    "nsstate_from_numpy",
    "nsstate_to_numpy",
    "run_steps",
    "slice_chains",
    "stack_results",
    "stack_states",
    "unstack_results",
    "unstack_states",
    "equal_weights_matrix",
    "posterior_stats",
    "resample_equal",
    "MergedRun",
    "merge_results",
    "nlive_of_logl",
    "RankDiagnostic",
    "insertion_rank_test",
    "ClusterReport",
    "assign_clusters",
    "posterior_cluster_report",
    "DynamicResults",
    "dynamic_sample",
    "posterior_ess",
    "ConvergedRun",
    "LadderRung",
    "converged_sample",
]
