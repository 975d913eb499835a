"""Posterior plotting and fit reporting (the ``doplot`` phase).

A port of :mod:`mcalf_tpu.plotting`.  It reads the chain files back (the
boundary between fit and analysis), prints the summary banner (logZ, lnL,
chi^2, AIC, ncomp occurrence fractions) and renders the multi-panel PDF:
data step plot + noise, posterior-draw overlays, per-component dotted
profiles with tick marks at (1+z) * wrest.

``run_plot`` works in two steps.  :func:`plot_data` computes every array the
figure needs: the banner's numbers and the per-component curves on the
host in float64 (the port's numpy :class:`AbsorptionModel`, so the banner
is the JAX package's digit for digit), and the posterior-draw overlays as
ONE batch through :meth:`TorchForward.reconstruct` on the device
``[run] device`` names -- one ``voigt_tau`` launch on a CUDA card.  Then
``run_plot`` prints the banner and renders with matplotlib.  Where
matplotlib is not installed it says so in one line and writes no PDF; the
overlays have run all the same.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mcalf_torch.analysis import analyze_chains, ncomp_occurrence
from mcalf_torch.models import AbsorptionModel, make_torch_forward
from mcalf_torch.runner import build_model, chain_basename, resolve_device

__all__ = [
    "PlotData",
    "plot_data",
    "posterior_overlays",
    "run_plot",
    "plot_diagnostics",
]

#: posterior draws overlaid on each panel (at most)
NDRAWS = 100


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as pl

    return pl


def _no_matplotlib(path: str) -> None:
    print(f"NOTE: matplotlib is not installed; {path} was not written.")


def plot_diagnostics(results, ns_config, path: str) -> Optional[str]:
    """Write the sampler-diagnostics PNG: logL(logX) trajectory, nlive(logL)
    from birth contours, and the insertion-rank histogram with its KS
    p-values (:mod:`mcalf_torch.sampler.diagnostics`).  ``results``: an
    :class:`NSResults` (tensors or host numpy).  Returns the path, or None
    where matplotlib is not installed."""
    from mcalf_torch.sampler import insertion_rank_test, merge_results

    pl = _pyplot()
    if pl is None:
        _no_matplotlib(path)
        return None
    results = results.numpy()
    cfg = ns_config.resolved()
    fig, axes = pl.subplots(1, 3, figsize=(16, 4.2))

    # Panel 1: logL vs logX (cumulated prior volume in death order).
    merged = merge_results([results])
    logx = np.cumsum(-1.0 / merged.nlive_at_death)
    axes[0].plot(logx, merged.logl, lw=0.8)
    axes[0].set_xlabel(r"$\ln X$")
    axes[0].set_ylabel(r"$\ln L$")
    axes[0].set_title("likelihood vs prior volume")
    axes[0].invert_xaxis()

    # Panel 2: live-point count along the run (birth-contour bookkeeping).
    axes[1].plot(merged.logl, merged.nlive_at_death, lw=0.8)
    axes[1].set_xlabel(r"$\ln L$")
    axes[1].set_ylabel("live points")
    axes[1].set_title("nlive($\\ln L$)")

    # Panel 3: insertion-rank uniformity (Fowlie et al. 2020).
    diag = insertion_rank_test(results, cfg)
    nbins = 20
    axes[2].hist(
        diag.ranks / max(diag.n_levels - 1, 1),
        bins=nbins,
        density=True,
        alpha=0.75,
    )
    axes[2].axhline(1.0, color="k", ls="--", lw=0.8)
    # bin-count band inflated by the shared-survivor-set factor kappa
    # (see sampler.diagnostics), like the p-values
    se = np.sqrt(diag.kappa * nbins / max(diag.n, 1))
    axes[2].axhspan(1 - 2 * se, 1 + 2 * se, color="k", alpha=0.1)
    axes[2].set_xlabel("insertion rank (normalized)")
    axes[2].set_ylabel("density")
    axes[2].set_title(
        f"rank uniformity: p={diag.p_value:.3f} "
        f"(blocks {diag.p_value_blocks:.3f}, $\\kappa$={diag.kappa:.2f})"
    )

    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    pl.close(fig)
    print(f"Diagnostics written at: {path}")
    return path


def posterior_overlays(model: AbsorptionModel, fwd, rows: np.ndarray) -> np.ndarray:
    """Model flux (n, P) of n posterior rows (n, ndim), float64 numpy, in
    one :meth:`TorchForward.reconstruct` call on ``fwd``'s device (a
    ``conv_mode='wrap'`` forward reproduces ``model.reconstruct_spec``).

    Never-active component columns (NaN after the z-sort) take the prior
    midpoint: ``reconstruct`` masks them, but a 0 there would give b = 0,
    dnu = 0 and a masked amplitude of 0 * inf = NaN in every pixel.  Each
    transition's z - zmid is formed here in float64 (a float32 redshift
    moves the line by ~2e-7 in z, up to ~5e-4 in flux)."""
    mid = 0.5 * (model.bounds_lo + model.bounds_hi)
    filled = np.where(np.isnan(rows), mid, rows)
    zidx = model.transition_table()["pidx"] + 1
    device = fwd.d0.device
    p = torch.from_numpy(filled.astype(np.float32)).to(device)
    dz = torch.from_numpy((filled[:, zidx] - mid[zidx]).astype(np.float32)).to(device)
    return fwd.reconstruct(p, dz=dz).cpu().numpy()


@dataclass
class PlotData:
    """What the fit PDF shows, computed before any rendering."""

    lnz: float
    lnlhood: float
    chi2: float
    aic: float
    #: ncomp values, their occurrence fractions, the MAP ncomp
    ncomp: np.ndarray
    frac: np.ndarray
    map_ncomp: int
    #: the posterior rows drawn for the overlays, and their model flux
    draws: np.ndarray
    overlays: np.ndarray
    #: per-component median profiles: (flux, line colour, tick wavelengths,
    #: tick colour)
    components: List[Tuple[np.ndarray, str, List[float], str]]

    def banner(self) -> List[str]:
        lines = [
            "________________________________________________________________",
            "| Ln(z): {0:6.3f}, Ln(L): {1:6.3f}, Chi2: {2:6.3f}, AIC: {3:6.3f}".format(
                self.lnz, self.lnlhood, self.chi2, self.aic
            ),
        ]
        lines += [
            "| Ncomp: {0:02d} Occurrence Fraction: {1:4.3f}".format(int(n), f)
            for n, f in zip(self.ncomp, self.frac)
        ]
        lines.append("|_______________________________________________________________")
        return lines

    def statstring(self) -> str:
        return r"$\ln(z): {0:6.3f},~\ln(L): {1:6.3f},~\chi^2: {2:6.3f},~AIC: {3:6.3f}$".format(
            self.lnz, self.lnlhood, self.chi2, self.aic
        )


def plot_data(configpars: Dict[str, Any], model: AbsorptionModel) -> PlotData:
    """Every array the fit PDF needs, from the chain files of
    ``configpars`` (which must exist); the overlays on ``[run] device``."""
    lnz, _, lhoodval, values = analyze_chains(
        chain_basename(configpars), return_sorted=True, nfill=int(model.nfill)
    )

    # Never-active component columns are all-NaN by construction
    # (sort_components); their median is legitimately NaN -- keep the
    # console clean of numpy's warning about it.
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="All-NaN slice encountered")
        meds = np.nanpercentile(values, 50, axis=0)

    if model.freecont:
        continuum = meds[1] if model.freespecres else meds[0]
    else:
        continuum = float(model.contval[0])
    if model.freespecres:
        specresolution = meds[0]
    else:
        specresolution = float(model.specres[0])

    ncomp_arr, ncomp_frac, map_ncomp = ncomp_occurrence(values, model.startind)

    lnlhood = np.percentile(lhoodval, 50)
    aic = 2 * model.ndim - 2 * lnlhood
    # chi^2 at the medians, never-active columns at the prior midpoint (see
    # posterior_overlays; any finite value is masked the same way).  The
    # reference passes (AIC, chi2) into a "(chi2, AIC)" template, printing
    # each under the other's label -- the JAX package fixed that, as here.
    mid = 0.5 * (model.bounds_lo + model.bounds_hi)
    chi2 = model.chi2(np.where(np.isnan(meds), mid, meds))

    nsamp = min(len(values), NDRAWS)
    if nsamp < NDRAWS:
        rsamples = np.arange(nsamp)
    else:
        rng = np.random.default_rng(0)
        rsamples = rng.integers(values.shape[0], size=nsamp)
    draws = values[rsamples]
    fwd = make_torch_forward(model, resolve_device(configpars), conv_mode="wrap")
    overlays = posterior_overlays(model, fwd, draws)

    # Per-component median profiles + tick marks.
    components = []
    for i in range(model.ncompmax + model.nfill):
        sl = meds[1 + 3 * i + model.startind : 4 + 3 * i + model.startind]
        if sl.size < 3 or not np.all(np.isfinite(sl)):
            continue
        _N, _z, _b = sl
        if _z < 10 and i <= map_ncomp:
            spec1 = model.reconstruct_onecomp(specresolution, continuum, _N, _z, _b)
            ticks = [line.wrest * (1 + _z) for line in model.lines]
            components.append((spec1, "dodgerblue", ticks, "blue"))
        else:
            spec1 = model.reconstruct_onecomp_fill(
                specresolution, continuum, _N, _z, _b
            )
            components.append((spec1, "salmon", [model.linefill.wrest * (1 + _z)], "red"))

    return PlotData(
        lnz=lnz, lnlhood=lnlhood, chi2=chi2, aic=aic, ncomp=ncomp_arr,
        frac=ncomp_frac, map_ncomp=map_ncomp, draws=draws, overlays=overlays,
        components=components,
    )


def run_plot(
    configpars: Dict[str, Any],
    debug: bool = False,
    model: AbsorptionModel | None = None,
) -> str | None:
    """Analyze the chains, print the banner and write the fit PDF.  Returns
    the PDF path, or None if no chain file exists or matplotlib is not
    installed."""
    base = chain_basename(configpars)
    print("Analyzing run: " + configpars["chainfmt"].format(""))
    if not os.path.exists(base + "_equal_weights.txt"):
        print(f"No chain file at {base}_equal_weights.txt; nothing to plot.")
        return None

    if model is None:
        model = build_model(configpars, debug=debug)
    d = plot_data(configpars, model)
    for line in d.banner():
        print(line)

    pdf = os.path.join(
        configpars["plotdir"],
        configpars["chainfmt"].format(model.nfill) + ".pdf",
    )
    pl = _pyplot()
    if pl is None:
        _no_matplotlib(pdf)
        return None
    pl.rc("text", usetex=False)
    pl.rcParams["font.size"] = 20

    nmaxcols = int(configpars["nmaxcols"])
    nrows = model.numfitranges // nmaxcols + (
        1 if model.numfitranges % nmaxcols > 0 else 0
    )
    ncols = model.numfitranges if nrows == 1 else nmaxcols

    fig, ax = pl.subplots(
        nrows=int(nrows),
        ncols=int(ncols),
        sharey=True,
        figsize=(10 * ncols, 5.5 * nrows),
        squeeze=False,
    )

    nsamp = len(d.draws)
    for waverange in range(model.numfitranges):
        colind = int(waverange % nmaxcols)
        rowind = int(waverange // nmaxcols)
        a = ax[rowind, colind]
        a.step(model.obj_wl, model.obj, color="black", where="mid", lw=1)
        a.plot(model.obj_wl, model.obj_noise, "-b", lw=0.5)
        a.set_xlim(configpars["wavefit"][waverange])
        a.set_ylim(configpars["yrange"])

        # Posterior-draw overlays: the same curves on every panel.
        for tspec in d.overlays:
            a.plot(
                model.obj_wl,
                tspec,
                color="red",
                alpha=max(1 - 8e-3 * nsamp, 0.05),
                lw=max(2 - 1.7e-2 * nsamp, 0.3),
                rasterized=False,
            )

        for spec1, color, ticks, tick_color in d.components:
            for w in ticks:
                a.plot([w, w], [1.06, 1.10], color=tick_color)
            a.plot(model.obj_wl, spec1, color=color, ls="dotted", lw=0.8, zorder=1)

    fig.tight_layout()
    pl.subplots_adjust(top=0.91)
    pl.text(0.04, 0.93, d.statstring(), ha="left", transform=fig.transFigure)

    os.makedirs(configpars["plotdir"], exist_ok=True)
    pl.savefig(pdf)
    pl.close(fig)
    print("PDF written at: {}".format(pdf))
    print("End of Job.")
    return pdf
