"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Every ``csrc/*.cu`` source is compiled by ONE ``nvcc`` call at first use,
for ``sm_90a``, into one shared library of plain C entry points, in
``build/mcalf_torch/<hash>/`` beside the package (a directory git ignores),
keyed by a hash of the sources, the shared headers, the generated header
and the compiler flags, so an edited source rebuilds and an unchanged one
loads from the cache; a lock file in that directory makes processes that
start together build once.  ``--use_fast_math`` is deliberately absent: it
would turn ``expf`` and the divisions into approximations, and the accuracy
bars are those of full-precision float32.

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent code only needs ``nvcc`` when a CUDA tensor asks
for a kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from mcalf_torch.ops import faddeeva

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "mcalf_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


class BuiltLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    #: wall seconds nvcc took in this process (0.0 when loaded from cache)
    build_seconds: float
    #: nvcc/ptxas output (registers, shared memory, spills per kernel), read
    #: back from the build directory when the library was built before
    log: str


def _c_array(vals) -> str:
    return "{" + ", ".join(f"{float(v)!r}f" for v in vals) + "}"


def _c_float(v) -> str:
    return f"{float(v)!r}f"


def coefficient_header() -> str:
    """The kernels' constant tables, generated from ops/faddeeva.py."""
    from mcalf_torch.models.forward import TAU_CONST
    from mcalf_torch.ops.convolve import FWHM_TO_SIGMA

    f = faddeeva
    lines = [
        "// Generated by mcalf_torch/ops/_build.py from mcalf_torch/ops/faddeeva.py.",
        "#pragma once",
        f"#define MCALF_DAWSN_P1 {_c_array(f.DAWSN_P1)}",
        f"#define MCALF_DAWSN_P2 {_c_array(f.DAWSN_P2)}",
        f"#define MCALF_DAWSN_P3 {_c_array(f.DAWSN_P3)}",
        f"#define MCALF_DAWSN_P4 {_c_array(f.DAWSN_P4)}",
        f"#define MCALF_TWO_OVER_SQRTPI {_c_float(f.TWO_OVER_SQRTPI)}",
        f"#define MCALF_PI {_c_float(math.pi)}",
        f"#define MCALF_INV_SQRTPI {_c_float(1.0 / math.sqrt(math.pi))}",
        f"#define MCALF_ERFCX_COEF {_c_array(f.ERFCX_COEF)}",
        f"#define MCALF_916_N_TERMS {f.N_TERMS}",
        f"#define MCALF_916_N_MID {f.N_MID}",
        f"#define MCALF_916_AN_MID {_c_float(f.AN[f.N_MID])}",
        f"#define MCALF_916_AN_HI {_c_float(f.AN[-1])}",
        f"#define MCALF_916_LO_CUT {_c_float(f.LO_CUT)}",
        f"#define MCALF_916_HI_CUT {_c_float(f.HI_CUT)}",
        f"#define MCALF_916_AN2 {_c_array(f.AN2)}",
        f"#define MCALF_916_EXP_AN2 {_c_array(f.EXP_AN2)}",
        f"#define MCALF_916_UP {_c_array(f.UP_RATIO)}",
        f"#define MCALF_916_INV_UP {_c_array(1.0 / r for r in f.UP_RATIO)}",
        f"#define MCALF_E_QUARTER {_c_float(f.E_QUARTER)}",
        f"#define MCALF_R2_SWITCH {_c_float(f.R2_SWITCH)}",
        f"#define MCALF_HARRIS_A_MAX {_c_float(np.float32(f.HARRIS_A_MAX))}",
        # the float32 values PyTorch's kernels use for the glue's Python
        # constants: TAU_CONST and 4 pi (a scalar operand, cast to float32),
        # and 1 / FWHM_TO_SIGMA (a division by a scalar, on CUDA a product
        # with its float32 reciprocal)
        f"#define MCALF_TAU_CONST {_c_float(np.float32(TAU_CONST))}",
        f"#define MCALF_FOUR_PI {_c_float(np.float32(4.0 * math.pi))}",
        "#define MCALF_INV_FWHM_TO_SIGMA "
        f"{_c_float(np.float32(1.0) / np.float32(FWHM_TO_SIGMA))}",
    ]
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
        "built from mcalf_torch/csrc at first use and need the CUDA toolkit"
    )


@functools.lru_cache(maxsize=None)
def load() -> BuiltLibrary:
    """Build (if needed) and load every ``csrc/*.cu`` as one ctypes library."""
    sources = sorted(CSRC.glob("*.cu"))
    header = coefficient_header()
    key = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu*")):
        key.update(path.name.encode())
        key.update(path.read_bytes())
    key.update(header.encode())
    key.update(" ".join(NVCC_FLAGS).encode())
    out_dir = BUILD_ROOT / f"kernels-{key.hexdigest()[:16]}"
    lib_path = out_dir / "libmcalf_kernels.so"
    seconds, log = 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    # Processes started together (a torchrun fleet) build once: the first
    # to take the lock builds, the others wait and load its library.
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and (out_dir / "build.log").exists():
            log = (out_dir / "build.log").read_text()
        if not lib_path.exists():
            (out_dir / "mcalf_coefs.h").write_text(header)
            tmp = out_dir / f"libmcalf_kernels.so.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(out_dir), "-I", str(CSRC),
                   "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed building {CSRC}/*.cu:\n{log}")
            os.replace(tmp, lib_path)
    return BuiltLibrary(ctypes.CDLL(str(lib_path)), lib_path, seconds, log)
