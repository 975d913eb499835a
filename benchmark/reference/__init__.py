"""The benchmark's plain references: float64 numpy/scipy, independent of the
fitter (it imports nothing of it)."""
