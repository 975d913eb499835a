from mcalf_torch.utils.profiling import get_timings, phase_timer, reset_timings, trace
from mcalf_torch.utils.stats import sigma_clipped_stats

__all__ = ["get_timings", "phase_timer", "reset_timings", "sigma_clipped_stats", "trace"]
