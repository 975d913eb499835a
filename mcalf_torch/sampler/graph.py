"""The slice loop on the device: k slice iterations per replayed CUDA graph.

The JAX package runs the whole slice loop inside one device program
(``mcalf_tpu/sampler/nested.py``: ``slice_chains``' ``lax.while_loop``), so
the host never waits on an iteration.  Here a block of k iterations of the
loop's body (:func:`mcalf_torch.sampler.nested._slice_iter`) is captured
once as a ``torch.cuda.CUDAGraph`` over static buffers and replayed: one
``cudaGraphLaunch`` stands for the roughly hundred kernel launches of k
iterations, and the host reads the loop's flags only between replays (the
read schedule is :func:`mcalf_torch.sampler.nested._block_loop`'s).

:class:`BlockGraph` does the CUDA part:

* warm-up: one call of the body on scratch buffers, on a side stream, so
  that every lazy initialisation (the kernels' library, the mode table's
  device read in ``voigt_cuda._any_damped``, the allocator) happens outside
  the capture; each generator is put back afterwards, so the warm-up does
  not advance the run.  The offset a generator advanced in it is the
  Philox offset one iteration draws, which the sampler uses to set each
  generator where the eager loop would leave it;
* capture: every problem's ``torch.Generator`` is registered with the
  graph (``CUDAGraph.register_generator_state``), so a replay draws from
  each generator's current offset and advances it by what the captured
  draws take, as the same calls made eagerly would;
* counts: the launches the kernel wrappers count during the capture
  (:func:`mcalf_torch.utils.profiling.count_launch`) are counted again at
  every replay, so ``voigt_cuda.launches`` counts the launches the card
  ran.  :data:`stats` counts captures, replays, the iterations they ran,
  warm-up iterations and flag reads in this process.

A likelihood that cannot be captured (one that reads the device, such as a
``.item()`` or a ``bool`` of a CUDA tensor) makes the capture raise, naming
the likelihood; nothing falls back to the eager loop.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import torch

from mcalf_torch.utils.profiling import captured_launches

__all__ = ["BlockGraph", "count", "stats", "reset_stats"]

#: what the captured slice loops of this process did: graphs captured,
#: replays, slice iterations those replays ran, warm-up iterations, and
#: host reads of the loop's flags
stats = dict(captures=0, replays=0, iterations=0, warmups=0, reads=0)
_stats_lock = threading.Lock()


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0


def count(**added: int) -> None:
    """Add to :data:`stats` (from any thread: a fleet's blocks on several
    local devices run from their own host threads)."""
    with _stats_lock:
        for k, n in added.items():
            stats[k] += n


class BlockGraph:
    """``block()`` captured once as a CUDA graph and replayed.

    ``warmup()`` is called once, eagerly, on a side stream before the
    capture; it must touch no buffer the run needs (the sampler gives it
    scratch copies of the loop's carry) and make one draw from each of
    ``gens``, which are put back afterwards.  ``iterations``: the slice
    iterations one replay runs (for :data:`stats`).  ``name`` names the likelihood in the error a failed
    capture raises."""

    def __init__(self, block: Callable[[], None], warmup: Callable[[], None],
                 gens: Sequence[torch.Generator], *, iterations: int, name: str):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} has no CUDAGraph.register_generator_state: "
                "the slice loop's captured draws need it"
            )
        self.iterations = iterations
        saved = [g.get_state() for g in gens]
        before = [g.get_offset() for g in gens]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        #: Philox offset each generator advances per iteration
        self.draw_offset = [g.get_offset() - b for g, b in zip(gens, before)]
        for g, s in zip(gens, saved):
            g.set_state(s)
        count(warmups=1)

        self.graph = torch.cuda.CUDAGraph()
        for g in gens:
            self.graph.register_generator_state(g)
        failure = None
        with captured_launches() as self._count_launches:
            try:
                # thread_local: another thread's fleet block, capturing or
                # running on another device, does not break this capture
                with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                    try:
                        block()
                    except Exception as e:  # the capture then fails to end, too
                        failure = e
            except Exception as e:
                failure = failure or e
        if failure is not None:
            raise RuntimeError(
                f"the likelihood {name} cannot be captured in a CUDA graph (the "
                "slice loop on a CUDA device runs only as replays of one): "
                f"{type(failure).__name__}: {failure}"
            ) from failure
        count(captures=1)

    def replay(self) -> None:
        self.graph.replay()
        self._count_launches()
        count(replays=1, iterations=self.iterations)
