"""Process-rank console gating for multi-process fleets.

Port of :mod:`mcalf_tpu.utils.rank`: the reference prints from MPI rank 0
only, so a fleet of processes prints one banner, not one per process.  The
port's distributed runtime is ``torch.distributed``; these helpers answer
"should this process own console output?" without initialising anything.
"""

from __future__ import annotations

import os

__all__ = ["is_rank0", "rank0_print"]


def is_rank0() -> bool:
    """True when this process should own console output: the
    ``torch.distributed`` rank where a process group is initialised, else
    the ``RANK`` environment variable (which ``torchrun`` sets), else rank 0
    (a single process, or a rank that cannot be read: printing twice beats
    swallowing output on a misdetected rank)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except Exception:
        pass
    try:
        return int(os.environ.get("RANK", "0")) == 0
    except ValueError:
        return True


def rank0_print(*args, **kwargs) -> None:
    """``print`` that only rank 0 of a multi-process fleet executes."""
    if is_rank0():
        print(*args, **kwargs)
