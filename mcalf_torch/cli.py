"""Console entry point: ``python -m mcalf_torch <config.ini> [--debug]``
(installed as ``mc-alf-torch``).

Same interface as ``mc-alf-tpu``: positional config file, ``--debug`` for
verbosity, ``--version``.  The fit runs the port's nested sampler on the
device ``[run] device`` names (the GPU by default), whichever of the
runner's fits the config asks for (:mod:`mcalf_torch.runner`); ``specfile``
as a list fits the spectra together as one fleet when they stack, else one
after another.  Under ``torchrun --nproc_per_node N -m mcalf_torch
fit.cfg`` (``WORLD_SIZE`` > 1 in the environment) the processes join one
group (:func:`mcalf_torch.parallel.init_distributed`) and split a seed
ensemble or a spectrum list whose count N divides; only rank 0 prints,
writes the chain files and plots, and each process reports its wall and
fused-kernel launches in one line on its stderr.  Plotting
(:mod:`mcalf_torch.plotting`) reads the chain files back, so
``dofit``/``doplot`` can run in separate invocations; with several spectra
it plots each.
"""

from __future__ import annotations

import argparse
import os
import time

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

    distributed = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if not distributed:
        return _run(args, configpars)
    import torch
    import torch.distributed as dist

    from mcalf_torch.parallel import init_distributed

    on_cpu = str(configpars.get("device", "default")).strip().lower() == "cpu"
    init_distributed(local_device_ids=["cpu"] if on_cpu else None)
    device = "cpu" if on_cpu else f"cuda:{torch.cuda.current_device()}"
    t0 = time.perf_counter()
    rc = _run(args, configpars)
    _report_rank(time.perf_counter() - t0, device)
    dist.destroy_process_group()
    return rc


def _report_rank(wall: float, device: str) -> None:
    """One line per process of a multi-process run, on its stderr (the
    other ranks' stdout is silenced): its rank, device, wall seconds and
    fused-kernel launches."""
    import sys

    import torch.distributed as dist

    from mcalf_torch.ops import voigt_cuda

    print(
        f"mcalf_torch rank {dist.get_rank()} of {dist.get_world_size()} on {device}: "
        f"wall {wall:.3f} s, fused-kernel launches {voigt_cuda.launches}",
        file=sys.stderr, flush=True,
    )


def _run(args, configpars) -> int:
    # Multi-process fleets print from rank 0 only (the reference gates its
    # output to MPI rank 0); is_rank0 initialises nothing.
    from mcalf_torch.utils.rank import is_rank0, writes_files

    if not is_rank0():
        import sys

        sys.stdout = open(os.devnull, "w")

    print(f"MC-ALF-Torch version {__version__}")
    if args.debug:
        print("--- DEBUG mode, increased verbosity ---")
    os.makedirs(configpars["chaindir"], exist_ok=True)
    os.makedirs(configpars["plotdir"], exist_ok=True)

    # Heavy imports after arg parsing so --help/--version stay fast.
    from mcalf_torch.plotting import run_plot
    from mcalf_torch.runner import build_model, run_fit, spectrum_subconfigs

    if len(configpars.get("specfiles") or []) > 1:
        # Several sightlines: one fit and one plot per spectrum.
        if configpars["dofit"]:
            run_fit(configpars, debug=args.debug)
        if configpars["doplot"] and writes_files():
            for sub in spectrum_subconfigs(configpars):
                run_plot(sub, debug=args.debug)
        return 0

    model = build_model(configpars, debug=args.debug)
    if args.debug:
        print(
            f"[DEBUG]: ndim={model.ndim}, npix={model.npix}, "
            f"velstep={model.velstep:.5f} km/s, lines={[l.name for l in model.lines]}"
        )
    if configpars["dofit"]:
        run_fit(configpars, debug=args.debug, model=model)
    if configpars["doplot"] and writes_files():
        run_plot(configpars, debug=args.debug, model=model)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
