"""INI configuration system, compatible with the reference's config files.

A copy of :mod:`mcalf_tpu.config` (the port imports nothing of the JAX
package); tests/test_torch_host_copies.py holds the two equal.

Same sections/keys/defaults as the reference ``readconfig``
(the reference's mcalf/routines/hires_fitter.py:762-969), with the bugs
catalogued in SURVEY.md section 5.6 fixed rather than replicated:

* default ``chainfmt`` is a *valid* format string (the reference default
  ``'pc_fits_{}_{1}'`` is malformed, :835);
* ``nmaxcols`` parses the full integer (the reference reads only the first
  character, :886);
* ``mn_settings`` is exposed under the key the CLI actually reads;
* solver settings sections are normalized so every solver name maps onto the
  native on-device sampler with its own section's tuning applied.

Extensions over the reference (all optional keys):
* ``[input] atomfile``  -- extra/override atomic data (see mcalf_torch.atomic);
* ``[ns_settings]``     -- direct tuning of the native sampler;
* ``[run] seed``        -- RNG seed (default 43, the reference's jaxns key,
  cli.py:280);
* ``[run] checkpoint``  -- sampler-state checkpoint directory.
"""

from __future__ import annotations

import configparser
from typing import Any, Dict

import numpy as np

__all__ = ["readconfig"]

_TRUE = {"true", "1", "yes", "on"}
_FALSE = {"false", "0", "no", "off"}


def _parse_bool(val: str, where: str = "") -> bool:
    """Tolerant boolean for config values.

    The reference crashes with a bare ``KeyError`` on ``asymmlike = true``
    (hires_fitter.py:803-804 indexes a {'True','False'} dict); per the
    SURVEY 5.6 fix-the-bugs policy we accept the usual INI spellings
    case-insensitively and raise a *readable* error on anything else.
    """
    s = str(val).strip().lower()
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    raise ValueError(
        f"Invalid boolean {val!r}{where}: expected one of "
        "True/False, 1/0, yes/no, on/off (case-insensitive)"
    )


def _floats(s: str) -> np.ndarray:
    return np.array([x.strip() for x in s.split(",")], dtype=float)


def _settings_dict(cp: configparser.ConfigParser, section: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for opt in cp.options(section):
        val = cp.get(section, opt)
        # Only unambiguous true/false literals convert here (1/0 stay
        # strings -- they could be numeric settings); runner._as_bool
        # handles the rest per-key with its documented default.
        low = val.strip().lower()
        out[opt] = low == "true" if low in ("true", "false") else val
    return out


def readconfig(configfile: str) -> Dict[str, Any]:
    """Parse a fit configuration file into the flat run-params dict
    (reference ``readconfig`` interface, hires_fitter.py:762-969)."""
    cp = configparser.ConfigParser()
    read = cp.read(configfile)
    if not read:
        raise FileNotFoundError(f"Config file not found or empty: {configfile!r}")

    # --- mandatory [input] keys -------------------------------------------
    if not cp.has_option("input", "specfile"):
        raise configparser.NoOptionError("specfile", "input")
    if not cp.has_option("input", "wavefit"):
        raise configparser.NoOptionError("wavefit", "input")
    toks = cp.get("input", "wavefit").split(",")
    if len(toks) % 2 == 1:
        raise ValueError("Number of wavefit values must be even")
    wavefit = [
        (float(toks[2 * i]), float(toks[2 * i + 1])) for i in range(len(toks) // 2)
    ]
    if not cp.has_option("input", "linelist"):
        raise configparser.NoOptionError("linelist", "input")
    linelist = [x.strip() for x in cp.get("input", "linelist").split(",")]

    def get(section, key, default=None, conv=None):
        if cp.has_option(section, key):
            v = cp.get(section, key)
            return conv(v) if conv else v
        return default

    coldef = [
        x.strip()
        for x in get("input", "coldef", "Wave, Flux, Err").split(",")
    ]
    specres = get("input", "specres", np.array([7.0]), _floats)
    asymmlike = get(
        "input", "asymmlike", False, lambda v: _parse_bool(v, " for [input] asymmlike")
    )
    solver = get("input", "solver", "polychord")
    atomfile = get("input", "atomfile", None)

    datadir = get("pathing", "datadir", "./")
    outdir = get("pathing", "outdir", "./")
    chaindir = outdir + get("pathing", "chaindir", "fits/")
    plotdir = outdir + get("pathing", "plotdir", "plots/")
    chainfmt = get("pathing", "chainfmt", "pc_fits_{0}")

    ncomp = get(
        "components", "ncomp", np.array((1, 1), dtype=int),
        lambda v: np.array(v.split(","), dtype=int),
    )
    nfill = get("components", "nfill", 0, int)
    contval = get("components", "contval", np.array([1.0]), _floats)
    Nrange = get("components", "Nrange", np.array((11.5, 16.0)), _floats)
    brange = get("components", "brange", np.array((1.0, 30.0)), _floats)
    zrange = get("components", "zrange", None, _floats)
    Nrangefill = get("components", "Nrangefill", np.array((11.5, 16.0)), _floats)
    brangefill = get("components", "brangefill", np.array((1.0, 30.0)), _floats)
    wrangefill = get("components", "wrangefill", None, _floats)
    # Gaussian priors: flat comma list alternating (value, sigma) per
    # dimension, 'none' for unconstrained -- the reference's Gpriors format
    # (hires_fitter.py:225-230), which its CLI never exposed; we do.
    gpriors = get(
        "components", "gpriors", None, lambda v: [x.strip() for x in v.split(",")]
    )

    nmaxcols = get("plots", "nmaxcols", 5, int)
    yrange = get("plots", "yrange", np.array((-0.1, 1.2)), _floats)

    dofit = get("run", "dofit", True, lambda v: _parse_bool(v, " for [run] dofit"))
    doplot = get("run", "doplot", True, lambda v: _parse_bool(v, " for [run] doplot"))
    showprogress = get(
        "run", "showprogress", False,
        lambda v: _parse_bool(v, " for [run] showprogress"),
    )
    # The reference defaults device=cpu (hires_fitter.py:962-965) because its
    # host samplers live there; our fit is the device's whole point, so the
    # default is the platform JAX picked (TPU when present).  An explicit
    # ``device = cpu`` forces the fit onto CPU in-process (reference
    # cli.py:215-216 semantics).
    device = get("run", "device", "default")
    seed = get("run", "seed", 43, int)
    checkpoint = get("run", "checkpoint", None)
    # Persistent XLA-executable cache directory ('off' disables; see
    # utils/compile_cache.py).  Config extension: the reference recompiles
    # its jaxns path every run.
    compile_cache = get("run", "compile_cache", None)
    # Fleet extensions (SURVEY.md section 2.3 "(spectrum x ncomp-candidate x
    # seed) fits across chips"):
    # * ``seeds = 43,44,45``: fit every seed (sharded over the mesh when it
    #   divides the device count, else sequentially), merge by birth
    #   contours, and write ONE merged .stats/chain plus per-member files.
    # * ``ncomp_grid = True``: instead of one trans-dimensional fit over
    #   [components] ncomp = lo,hi, run one FIXED-k fit per k in [lo, hi]
    #   and write a Bayes-factor table (the reference workflow's model
    #   selection, cli.py:367-383, done as an explicit grid).
    seeds = get(
        "run", "seeds", None, lambda v: [int(x) for x in v.split(",")]
    )
    ncomp_grid = get(
        "run", "ncomp_grid", False,
        lambda v: _parse_bool(v, " for [run] ncomp_grid"),
    )

    # Multi-sightline fleet extension: ``specfile`` accepts a comma list
    # and/or glob patterns (each resolved under datadir).  One entry keeps
    # the reference's exact single-spectrum semantics; several entries make
    # run_fit/cli fit each spectrum with the same settings (sharded over
    # the mesh when the problems stack) under a per-spectrum chain suffix
    # (SURVEY.md section 2.3 "(spectrum x ncomp x seed) across chips").
    import glob as _glob

    specfiles = []
    for tok in cp.get("input", "specfile").split(","):
        pat = datadir + tok.strip()
        hits = sorted(_glob.glob(pat))
        specfiles.extend(hits if hits else [pat])

    run_params: Dict[str, Any] = {
        "specfile": specfiles[0],
        "specfiles": specfiles,
        "wavefit": wavefit,
        "linelist": linelist,
        "coldef": coldef,
        "asymmlike": asymmlike,
        "solver": solver,
        "specres": specres,
        "atomfile": atomfile,
        "chaindir": chaindir,
        "plotdir": plotdir,
        "chainfmt": chainfmt,
        "ncomp": ncomp,
        "nfill": nfill,
        "Nrange": Nrange,
        "brange": brange,
        "zrange": zrange,
        "Nrangefill": Nrangefill,
        "brangefill": brangefill,
        "wrangefill": wrangefill,
        "gpriors": gpriors,
        "contval": contval,
        "nmaxcols": nmaxcols,
        "yrange": yrange,
        "dofit": dofit,
        "doplot": doplot,
        "showprogress": showprogress,
        "device": device,
        "seed": seed,
        "checkpoint": checkpoint,
        "compile_cache": compile_cache,
        "seeds": seeds,
        "ncomp_grid": ncomp_grid,
    }

    for section in ("mn_settings", "pc_settings", "jaxns_settings", "ns_settings"):
        if cp.has_section(section):
            run_params[section] = _settings_dict(cp, section)

    return run_params
