"""ASCII spectrum IO (replaces astropy.io.ascii for the reference's use).

The reference reads whitespace-separated tables with named columns via
``astropy.io.ascii.read`` (hires_fitter.py:69-72); the bundled mocks are
``np.savetxt`` tables whose first line is a commented header
(``# Wave Flux Err``, testdata/generate_from_model.py:64-69).  This reader
handles both commented and bare header lines and returns named float columns.

A copy of :mod:`mcalf_tpu.io.spectra` that parses with numpy instead of the
JAX package's native reader; tests/test_torch_host_copies.py holds the two
equal.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def read_spectrum_table(path: str) -> Dict[str, np.ndarray]:
    """Read a whitespace-separated spectrum table into {colname: float64 array}.

    Header resolution order:
    1. last comment line (``# ...``) before the data whose token count matches
       the data column count and whose tokens are not all numeric;
    2. a bare first non-comment line of non-numeric tokens;
    3. fallback names ``col0, col1, ...``.
    """
    # Header scan (python, first few lines only); the bulk numeric parse
    # starts at the first data row.
    header_tokens: List[str] | None = None
    pending_comment: List[str] | None = None
    skip = 0
    with open(path) as fh:
        for raw in fh:
            s = raw.strip()
            if not s or s.startswith("#"):
                toks = s.lstrip("#").split()
                if toks and not all(_is_number(t) for t in toks):
                    pending_comment = toks
                skip += 1
                continue
            toks = s.split()
            if not all(_is_number(t) for t in toks):
                header_tokens = toks
                skip += 1
                continue
            break  # first data row reached

    data = np.loadtxt(path, comments="#", skiprows=skip, ndmin=2)
    if data.size == 0:
        raise ValueError(f"No numeric data found in spectrum file {path!r}")
    ncols = data.shape[1]

    if header_tokens is None and pending_comment is not None and len(pending_comment) == ncols:
        header_tokens = pending_comment
    if header_tokens is None or len(header_tokens) != ncols:
        header_tokens = [f"col{i}" for i in range(ncols)]

    return {name: data[:, i] for i, name in enumerate(header_tokens)}


def load_spectrum(path: str, coldef: Sequence[str] = ("Wave", "Flux", "Err")):
    """Load (wave, flux, err) float64 arrays by column names (reference
    ``coldef`` semantics, hires_fitter.py:70-72)."""
    table = read_spectrum_table(path)
    out = []
    for name in coldef:
        if name not in table:
            raise KeyError(
                f"Column {name!r} not found in {path!r}; available: {sorted(table)}"
            )
        out.append(np.asarray(table[name], dtype=np.float64))
    return tuple(out)
