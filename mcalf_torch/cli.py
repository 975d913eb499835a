"""Console entry point: ``python -m mcalf_torch <config.ini> [--debug]``
(installed as ``mc-alf-torch``).

Same interface as ``mc-alf-tpu``: positional config file, ``--debug`` for
verbosity, ``--version``.  The fit runs the port's nested sampler on the
device ``[run] device`` names (the GPU by default).  Plotting is not ported
yet: with ``doplot`` set the command says so and skips it.
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
    print(f"MC-ALF-Torch version {__version__}")
    if args.debug:
        print("--- DEBUG mode, increased verbosity ---")
    os.makedirs(configpars["chaindir"], exist_ok=True)

    # Heavy imports after arg parsing so --help/--version stay fast.
    from mcalf_torch.runner import build_model, run_fit

    model = build_model(configpars, debug=args.debug)
    if args.debug:
        print(
            f"[DEBUG]: ndim={model.ndim}, npix={model.npix}, "
            f"velstep={model.velstep:.5f} km/s, lines={[l.name for l in model.lines]}"
        )
    if configpars["dofit"]:
        run_fit(configpars, debug=args.debug, model=model)
    if configpars["doplot"]:
        print(
            "NOTE: plotting is not ported to mcalf_torch yet (ROADMAP Queue 1: "
            "plotting); skipped.  `python -m mcalf_tpu` with [run] dofit = "
            "False plots these chain files."
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
