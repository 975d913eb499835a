"""Chain-file IO: the `.stats` and `_equal_weights.txt` formats.

These two on-disk formats are the API boundary between the fitting and
analysis phases in the reference (SURVEY.md section 5.4) and must be
byte-format compatible:

* ``.stats``: a line ``log(Z)   : <mean>   +/-   <uncert>``
  (written by the reference's mcalf/cli.py:294-295, parsed
  hires_fitter.py:709-714).
* ``_equal_weights.txt``: np.savetxt matrix with col0 weight (=1 after
  equal-weight resampling), col1 -2 lnL, cols 2+ the raw parameter vector
  (written cli.py:314-325, parsed hires_fitter.py:716-721).

A copy of :mod:`mcalf_tpu.io.chains` that writes and reads with numpy: the
JAX package's native writer is byte-identical to ``np.savetxt``'s default
format, and tests/test_torch_host_copies.py holds the two packages' files
byte-identical.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "write_stats",
    "read_stats",
    "write_equal_weights",
    "read_equal_weights",
]


def write_stats(path: str, logz: float, logzerr: float, extra_lines=()) -> None:
    """Write the `.stats` evidence file.  ``extra_lines`` (e.g. sampler
    health diagnostics) are appended as ``#``-prefixed comment lines --
    the reference parser (hires_fitter.py:709-714) only consumes lines
    starting ``log(Z)``, so comments are format-compatible."""
    with open(path, "w") as f:
        f.write("log(Z)   : {}   +/-   {}\n".format(float(logz), float(logzerr)))
        for line in extra_lines:
            f.write("# {}\n".format(line))


def read_stats(path: str) -> Tuple[float, float]:
    lnz = lnz_err = None
    with open(path) as f:
        for line in f:
            if line[:6] == "log(Z)":
                items = line.split()
                lnz = float(items[2])
                lnz_err = float(items[4])
    if lnz is None:
        raise ValueError(f"No 'log(Z) :' line found in {path!r}")
    return lnz, lnz_err


def write_equal_weights(path: str, matrix: np.ndarray) -> None:
    """np.savetxt's default format ("%.18e", space-separated)."""
    np.savetxt(path, np.atleast_2d(np.asarray(matrix, np.float64)))


def read_equal_weights(path: str) -> np.ndarray:
    return np.loadtxt(path, ndmin=2)
