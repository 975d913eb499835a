"""Console entry point: ``python -m mcalf_torch <config.ini> [--debug]``
(installed as ``mc-alf-torch``).

Same interface as ``mc-alf-tpu``: positional config file, ``--debug`` for
verbosity, ``--version``.  The fit runs the port's nested sampler on the
device ``[run] device`` names (the GPU by default), whichever of the
runner's fits the config asks for (:mod:`mcalf_torch.runner`); ``specfile``
as a list fits the spectra together as one fleet when they stack, else one
after another.  In a multi-process run only rank 0 prints.  Plotting is not ported yet: with
``doplot`` set the command says so, once per spectrum, and skips it.
"""

from __future__ import annotations

import argparse
import os

from mcalf_torch import __version__
from mcalf_torch.config import readconfig


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mc-alf-torch")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--version", action="version", version=f"mc-alf-torch {__version__}"
    )
    parser.add_argument("config")
    args = parser.parse_args(argv)

    configpars = readconfig(args.config)

    # Multi-process fleets print from rank 0 only (the reference gates its
    # output to MPI rank 0); is_rank0 initialises nothing.
    from mcalf_torch.utils.rank import is_rank0

    if not is_rank0():
        import sys

        sys.stdout = open(os.devnull, "w")

    print(f"MC-ALF-Torch version {__version__}")
    if args.debug:
        print("--- DEBUG mode, increased verbosity ---")
    os.makedirs(configpars["chaindir"], exist_ok=True)

    # Heavy imports after arg parsing so --help/--version stay fast.
    from mcalf_torch.runner import build_model, run_fit, spectrum_subconfigs

    if len(configpars.get("specfiles") or []) > 1:
        # Several sightlines: one fit (and one plot) per spectrum.
        if configpars["dofit"]:
            run_fit(configpars, debug=args.debug)
        if configpars["doplot"]:
            for sub in spectrum_subconfigs(configpars):
                _plot_note(sub)
        return 0

    model = build_model(configpars, debug=args.debug)
    if args.debug:
        print(
            f"[DEBUG]: ndim={model.ndim}, npix={model.npix}, "
            f"velstep={model.velstep:.5f} km/s, lines={[l.name for l in model.lines]}"
        )
    if configpars["dofit"]:
        run_fit(configpars, debug=args.debug, model=model)
    if configpars["doplot"]:
        _plot_note(configpars)
    return 0


def _plot_note(configpars) -> None:
    from mcalf_torch.runner import chain_basename

    print(
        "NOTE: plotting is not ported to mcalf_torch yet (ROADMAP Queue 1: "
        f"plotting); skipped for {chain_basename(configpars)}.  `python -m "
        "mcalf_tpu` with [run] dofit = False plots these chain files."
    )


if __name__ == "__main__":
    raise SystemExit(main())
