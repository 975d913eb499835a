from mcalf_torch.utils.stats import sigma_clipped_stats

__all__ = ["sigma_clipped_stats"]
