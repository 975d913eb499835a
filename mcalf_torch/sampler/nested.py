"""Batched nested sampling with slice-sampling replacements, in PyTorch.

Port of :mod:`mcalf_tpu.sampler.nested` (same algorithm, same bookkeeping,
same float32 arithmetic); see that module for the derivations.  In brief:

* ``num_delete`` worst live points are deleted per outer step; the j-th
  deleted point shrinks the prior volume by E[d ln X] = -1/(nlive - j), so
  batch deletion equals ``num_delete`` classic steps.
* Replacements come from ``num_repeats`` shrinkage slice-sampling passes
  per chain, started at distinct random survivors, along directions drawn
  up front from a four-family mixture (whitened per-cluster Gaussian,
  differential evolution, coordinate axes, triplet-restricted DE), with
  the exact cube-chord bracket (or, with ``bracket="stepout"``, Neal's
  bounded step-out intersected with the chord) and the hard constraint
  L > L* (the highest deleted likelihood).  Chains advance their passes
  asynchronously: one batched likelihood call per iteration, each chain
  moving on to its next pass as soon as it accepts.
* Termination when the live set's remaining evidence falls below
  ``precision_criterion`` of the accumulated one, or at ``max_samples``.

What differs from the JAX package is the PyTorch idiom: every random draw
comes from an explicit ``torch.Generator`` (the numbers are therefore not
``jax.random``'s), the outer loop is a Python loop (one host read per
outer step, for the termination test), and the state carries its scalar
counters as Python ints.  The slice loop, which the JAX package runs as a
``lax.while_loop`` inside the device program, runs on a CUDA device as
replays of a CUDA graph of :data:`BLOCK_ITERATIONS` iterations, the host
reading the loop's flags only between replays (:mod:`.graph`); on the CPU
it is an eager loop with one host read per iteration.  Both run the same
body (:func:`_slice_iter`) and give the same bits.  The JAX package's
``warmup_executables`` has no counterpart: a run captures its graph at its
first outer step (one warm-up iteration, then the capture), and keeps it.

Several independent problems run together as a fleet
(:func:`nested_sample_stacked`, the JAX package's ``vmap``/``shard_map``
over problems): their slice chains are stacked, so every slice iteration
is one likelihood call for all of them, while each problem keeps its own
generator, termination and chunk schedule; problem q ends bit for bit where
:func:`nested_sample` alone would take it.  :func:`nested_sample` is that
fleet with one problem.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "NSConfig",
    "NSResults",
    "NSState",
    "canonicalize_u",
    "finalize",
    "init_state",
    "is_done",
    "nested_sample",
    "nested_sample_stacked",
    "nsstate_from_numpy",
    "nsstate_to_numpy",
    "run_steps",
    "slice_chains",
    "stack_results",
    "stack_states",
    "unstack_results",
    "unstack_states",
    "DEFAULT_CHUNK_STEPS",
]

#: outer steps between host re-clustering boundaries, after the first
#: boundary at 8 steps (the JAX package's two 4-step probe chunks).  The
#: JAX package sized chunks to ~15 s of device time for its TPU runtime's
#: execution limit; here the chunk length is fixed in outer steps, so the
#: re-clustering cadence (which shapes the proposal mixture) does not
#: depend on how fast the machine is.
DEFAULT_CHUNK_STEPS = 32
_PROBE_STEPS = 8


@dataclass(frozen=True)
class NSConfig:
    """Sampler configuration; the fields and defaults of
    :class:`mcalf_tpu.sampler.nested.NSConfig`."""

    ndim: int
    nlive: int = 200
    #: live points deleted + replaced per outer step (0 -> nlive // 2)
    num_delete: int = 0
    #: slice-sampling passes per replacement (0 -> 12 * ndim, 24 * ndim
    #: under difficult_model)
    num_repeats: int = 0
    #: stop when Z_live / Z < precision_criterion
    precision_criterion: float = 1e-3
    #: cap on collected dead points (buffer size)
    max_samples: int = 20000
    #: max shrink iterations per slice pass
    max_shrink: int = 30
    #: doubles the default num_repeats
    difficult_model: bool = False
    #: slice-direction mixture weights (whitened-Gaussian, global DE,
    #: coordinate-axis[, triplet-DE])
    move_mix: tuple = (1.0, 1.0, 1.0)
    #: label-symmetry gauge fixing layout (startind, ncompmax, nfill[,
    #: ncomp_lo, ncomp_hi]); see AbsorptionModel.canon_layout
    canon_layout: Optional[tuple] = None
    #: bracket strategy for the slice passes: "chord" (the exact cube
    #: chord, the default) or "stepout" (Neal 2003's step-out with width
    #: ``stepout_w`` and a randomly split expansion budget
    #: ``stepout_budget``, intersected with the chord; the JAX package
    #: measured it unbiased but not cheaper than the chord)
    bracket: str = "chord"
    #: step-out initial width in t-units of the pass's direction
    stepout_w: float = 2.0
    #: step-out expansion budget m per pass: J ~ U{0..m-1} steps to the low
    #: end, K = m-1-J to the high end
    stepout_budget: int = 16
    #: live-point mode clustering at chunk boundaries (1 disables)
    max_clusters: int = 8

    def resolved(self) -> "NSConfig":
        """Fill defaulted fields (idempotent)."""
        nd = self.num_delete if self.num_delete > 0 else max(1, self.nlive // 2)
        nd = min(nd, self.nlive - 1)
        if self.num_repeats > 0:
            nr = self.num_repeats
        else:
            nr = 12 * self.ndim * (2 if self.difficult_model else 1)
        return dataclasses.replace(self, num_delete=nd, num_repeats=nr)


class NSState(NamedTuple):
    """Sampler state between outer steps (tensors on the run's device)."""

    live_u: torch.Tensor        # (nlive, ndim)
    live_logl: torch.Tensor     # (nlive,)
    live_birth: torch.Tensor    # (nlive,) birth contour
    dead_u: torch.Tensor        # (cap, ndim)
    dead_logl: torch.Tensor     # (cap,)
    dead_logw: torch.Tensor     # (cap,) log prior-mass weight
    dead_birth: torch.Tensor    # (cap,)
    n_dead: int
    logx: torch.Tensor          # () log remaining prior volume
    logz: torch.Tensor          # () accumulated log evidence
    n_like: int
    step: int
    dead_rank: torch.Tensor     # (cap,) int32 insertion ranks, -1 unfilled
    live_cluster: torch.Tensor  # (nlive,) int64 cluster ids
    #: the run's torch.Generator state (``gen.get_state()``, a uint8 tensor
    #: on the host) at the chunk boundary this state was handed out at; None
    #: inside a chunk and on a state that came from the JAX package.  Its
    #: size depends on the generator's device type.
    rng: Optional[torch.Tensor] = None


class NSResults(NamedTuple):
    logz: Any
    logzerr: Any
    h: Any
    samples_u: Any               # (cap + nlive, ndim)
    logl: Any                    # (cap + nlive,)
    logw: Any                    # (cap + nlive,)
    birth_logl: Any              # (cap + nlive,)
    log_posterior_weights: Any   # logw + logl - logz
    n_dead: int
    n_like: int
    n_iter: int
    termination_reason: int      # 0 = converged, 1 = max_samples
    insertion_rank: Any          # (cap + nlive,) int32, -1 = unfilled/live

    def numpy(self) -> "NSResults":
        """The same results with every tensor copied to a host numpy array."""
        return NSResults(
            *(x.detach().cpu().numpy() if torch.is_tensor(x) else x for x in self)
        )


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def init_state(
    loglike_batch: Callable, gen: torch.Generator, config: NSConfig,
    device: "torch.device | str",
) -> NSState:
    """Draw the initial live-point set and empty dead buffers."""
    cfg = config.resolved()
    live_u = _draw_live(gen, cfg, device)
    return _fresh_state(live_u, loglike_batch(live_u), cfg)


def _draw_live(gen, cfg: NSConfig, device) -> torch.Tensor:
    return _canon_live(
        torch.rand((cfg.nlive, cfg.ndim), generator=gen, dtype=torch.float32,
                   device=device),
        cfg,
    )


def _fresh_state(live_u, live_logl, cfg: NSConfig) -> NSState:
    """The state at step 0 around a drawn live set and its likelihoods."""
    ndim, nlive, cap = cfg.ndim, cfg.nlive, int(cfg.max_samples)
    f32 = torch.float32
    device = live_u.device
    return NSState(
        live_u=live_u,
        live_logl=live_logl,
        live_birth=torch.full((nlive,), -math.inf, dtype=f32, device=device),
        dead_u=torch.zeros((cap, ndim), dtype=f32, device=device),
        dead_logl=torch.full((cap,), -math.inf, dtype=f32, device=device),
        dead_logw=torch.full((cap,), -math.inf, dtype=f32, device=device),
        dead_birth=torch.full((cap,), math.inf, dtype=f32, device=device),
        n_dead=0,
        logx=_f32(0.0, device),
        logz=_f32(-math.inf, device),
        n_like=nlive,
        step=0,
        dead_rank=torch.full((cap,), -1, dtype=torch.int32, device=device),
        live_cluster=torch.zeros((nlive,), dtype=torch.int64, device=device),
    )


def nsstate_from_numpy(state: Any, device: "torch.device | str") -> NSState:
    """Build an :class:`NSState` on ``device`` from numpy-convertible fields:
    a mapping, or a named tuple such as the JAX package's NSState (whose
    PRNG ``key`` is dropped -- the port draws from a torch.Generator, so
    such a state has ``rng=None`` and resumes on the generator it is given).
    ``rng``, where present, stays on the host."""
    d = state._asdict() if hasattr(state, "_asdict") else dict(state)

    def t(name, dtype):
        return torch.as_tensor(np.array(d[name]), dtype=dtype, device=device)

    f32 = torch.float32
    return NSState(
        live_u=t("live_u", f32),
        live_logl=t("live_logl", f32),
        live_birth=t("live_birth", f32),
        dead_u=t("dead_u", f32),
        dead_logl=t("dead_logl", f32),
        dead_logw=t("dead_logw", f32),
        dead_birth=t("dead_birth", f32),
        n_dead=_count(d["n_dead"]),
        logx=t("logx", f32),
        logz=t("logz", f32),
        n_like=_count(d["n_like"]),
        step=_count(d["step"]),
        dead_rank=t("dead_rank", torch.int32),
        live_cluster=t("live_cluster", torch.int64),
        rng=(
            torch.from_numpy(np.array(d["rng"], dtype=np.uint8))
            if d.get("rng") is not None else None
        ),
    )


def _count(v):
    """A counter field: an int, or a tuple of ints on a stacked state."""
    a = np.asarray(v)
    return int(a) if a.ndim == 0 else tuple(int(x) for x in a)


_COUNTERS = ("n_dead", "n_like", "step")


def stack_states(states: Sequence[NSState]) -> NSState:
    """Several problems' states as one :class:`NSState` with a leading
    problem axis: tensors stacked, counters as tuples of ints, ``rng`` as a
    (Q, bytes) tensor (None unless every state carries one).  Saved and
    loaded by :mod:`mcalf_torch.utils.checkpoint` as any state."""
    out = {}
    for f in NSState._fields:
        vals = [getattr(s, f) for s in states]
        if f in _COUNTERS:
            out[f] = tuple(int(v) for v in vals)
        elif f == "rng":
            out[f] = None if any(v is None for v in vals) else torch.stack(vals)
        else:
            out[f] = torch.stack(vals)
    return NSState(**out)


def unstack_states(stacked: NSState) -> List[NSState]:
    """The per-problem states of :func:`stack_states`'s result."""
    return [
        NSState(**{f: None if v is None else v[q] for f, v in stacked._asdict().items()})
        for q in range(stacked.live_u.shape[0])
    ]


def stack_results(results: Sequence[NSResults]) -> NSResults:
    """Several problems' results with a leading problem axis (tensors
    stacked, integer fields as int64 numpy arrays)."""
    return NSResults(*(
        torch.stack(vals) if torch.is_tensor(vals[0]) else np.asarray(vals, np.int64)
        for vals in zip(*results)
    ))


def unstack_results(stacked: NSResults) -> List[NSResults]:
    """Problem by problem, the results of :func:`stack_results`."""
    return [
        NSResults(*(x[q] if torch.is_tensor(x) else int(x[q]) for x in stacked))
        for q in range(len(stacked.n_dead))
    ]


def nsstate_to_numpy(state: NSState) -> dict:
    """Host numpy copy of every field (scalars as 0-d arrays; ``rng`` is
    left out when the state carries none)."""
    out = {}
    for k, v in state._asdict().items():
        if v is None:
            continue
        out[k] = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def _recluster(state: NSState, cfg: NSConfig) -> NSState:
    """Host-side live-set re-clustering at a chunk boundary (no-op when
    clustering is disabled)."""
    if cfg.max_clusters <= 1:
        return state
    from mcalf_torch.sampler.clusters import assign_clusters

    labels, _ = assign_clusters(
        state.live_u.cpu().numpy(), max_clusters=cfg.max_clusters
    )
    return state._replace(
        live_cluster=torch.as_tensor(
            labels, dtype=torch.int64, device=state.live_u.device
        )
    )


def _remaining_logz(s: NSState, nlive: int) -> torch.Tensor:
    # Upper estimate of the evidence still in the live set.
    return (
        torch.logsumexp(s.live_logl, dim=0)
        - math.log(np.float32(nlive))
        + s.logx
    )


def _not_done(s: NSState, cfg: NSConfig) -> bool:
    B, cap = cfg.num_delete, int(cfg.max_samples)
    if s.n_dead + B > cap:
        return False
    log_eps = torch.log(_f32(cfg.precision_criterion, s.logz.device))
    live_ok = torch.isfinite(torch.logsumexp(s.live_logl, dim=0))
    not_converged = (
        _remaining_logz(s, cfg.nlive) - torch.clamp(s.logz, min=-1e30) > log_eps
    )
    return bool((not_converged | ~torch.isfinite(s.logz)) & live_ok)


def is_done(state: NSState, config: NSConfig) -> bool:
    """Has the run terminated (converged or capped)?"""
    return not _not_done(state, config.resolved())


def canonicalize_u(u: torch.Tensor, layout, ncomp_vals: torch.Tensor) -> torch.Tensor:
    """Map unit-cube points to their canonical label representative:
    component triplets sorted active-first, each group by z; filler
    triplets sorted by z among themselves.  A coordinate permutation per
    point (volume-preserving, likelihood-invariant under exchangeable
    priors)."""
    startind, ncompmax, nfill = layout
    base = startind + 1
    lead = u.shape[:-1]
    trip = u[..., base : base + 3 * ncompmax].reshape(lead + (ncompmax, 3))
    nact = torch.floor(ncomp_vals)[..., None]
    idx = torch.arange(ncompmax, dtype=u.dtype, device=u.device)
    key = torch.where(idx < nact, trip[..., 1], trip[..., 1] + 2.0)
    order = torch.argsort(key, dim=-1, stable=True)
    trip = torch.gather(trip, -2, order[..., None].expand(trip.shape))
    out = u.clone()
    out[..., base : base + 3 * ncompmax] = trip.reshape(lead + (3 * ncompmax,))
    if nfill > 1:
        fb = base + 3 * ncompmax
        ftrip = u[..., fb : fb + 3 * nfill].reshape(lead + (nfill, 3))
        forder = torch.argsort(ftrip[..., 1], dim=-1, stable=True)
        ftrip = torch.gather(ftrip, -2, forder[..., None].expand(ftrip.shape))
        out[..., fb : fb + 3 * nfill] = ftrip.reshape(lead + (3 * nfill,))
    return out


def _canon_live(live_u: torch.Tensor, cfg: NSConfig) -> torch.Tensor:
    """Apply the gauge fixing to a live-point set (no-op without layout).
    The optional 4th/5th layout entries are the physical bounds of the ncomp
    dimension (floor of the physical value is the active count)."""
    if cfg.canon_layout is None:
        return live_u
    startind = cfg.canon_layout[0]
    if len(cfg.canon_layout) == 5:
        lo, hi = cfg.canon_layout[3], cfg.canon_layout[4]
        ncomp_vals = lo + live_u[..., startind] * (hi - lo)
    else:
        ncomp_vals = live_u[..., startind]
    return canonicalize_u(live_u, cfg.canon_layout[:3], ncomp_vals)


def _cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Cholesky factor, NaN where the matrix is not positive definite (the
    behaviour of jnp.linalg.cholesky; torch.linalg.cholesky would raise)."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None], math.nan, L)


def _bracket(u_cur: torch.Tensor, d: torch.Tensor):
    """Exact cube-chord bracket: the extent of the line u_cur + t d inside
    the unit cube (a superset of the slice, so shrinkage alone is valid)."""
    safe_d = torch.where(d.abs() < 1e-12, 1e-12, d)
    c1 = (0.0 - u_cur) / safe_d
    c2 = (1.0 - u_cur) / safe_d
    lo = torch.amax(torch.minimum(c1, c2), dim=-1)
    hi = torch.amin(torch.maximum(c1, c2), dim=-1)
    return lo, hi


def _direction_pool(gen, surv_u, surv_cluster, cfg: NSConfig, B: int) -> torch.Tensor:
    """(num_repeats, B, ndim) slice directions, drawn up front: chain i's
    pass p uses pool[p, i].  The directions depend only on the survivor
    set and the generator, never on the chains' current points, as the
    slice kernel's validity requires."""
    dev = surv_u.device
    f32 = torch.float32
    ndim = cfg.ndim
    R = cfg.num_repeats
    nsurv = surv_u.shape[0]
    K = max(int(cfg.max_clusters), 1)

    # Affine whitening from survivor covariances, one Cholesky factor per
    # cluster (the global one when K == 1 / no labels).
    centered = surv_u - surv_u.mean(dim=0)
    cov_g = centered.T @ centered / (nsurv - 1)
    eye = torch.eye(ndim, dtype=f32, device=dev)
    if K == 1 or surv_cluster is None:
        K = 1
        chol_k = _cholesky_or_nan(cov_g + 1e-10 * eye)[None]
        n_k = torch.ones((1,), dtype=f32, device=dev)
    else:
        onehot = F.one_hot(surv_cluster, K).to(f32)                  # (nsurv, K)
        n_k = onehot.sum(dim=0)                                      # (K,)
        mean_k = (onehot.T @ surv_u) / torch.clamp(n_k, min=1.0)[:, None]
        cent_k = surv_u[None, :, :] - mean_k[:, None, :]             # (K, ns, d)
        cov_k = torch.einsum(
            "kn,kni,knj->kij", onehot.T, cent_k, cent_k
        ) / torch.clamp(n_k - 1.0, min=1.0)[:, None, None]
        # Tiny/empty clusters fall back to the global covariance.
        cov_k = torch.where((n_k >= 2)[:, None, None], cov_k, cov_g[None])
        chol_k = _cholesky_or_nan(cov_k + 1e-10 * eye[None])         # (K, d, d)

    n = torch.randn((R, B, ndim), generator=gen, dtype=f32, device=dev)
    n = n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-12)
    if K == 1:
        d_white = n @ chol_k[0].T
    else:
        # cluster frame per chain, drawn with probability n_k / nsurv
        cw = torch.multinomial(n_k, R * B, replacement=True, generator=gen)
        cw = cw.reshape(R, B)
        d_white = torch.zeros_like(n)
        for k in range(K):
            d_white = torch.where((cw == k)[..., None], n @ chol_k[k].T, d_white)

    w_white, w_de, w_axis = cfg.move_mix[:3]
    jidx = torch.randint(0, nsurv, (R, 2, B), generator=gen, device=dev)
    if K > 1:
        # Within-cluster DE pairs (a uniform member: argmax of iid uniform
        # scores over the cluster mask), keeping a 25% cross-cluster
        # fraction for mode-to-mode difference vectors.
        c2 = torch.multinomial(n_k, R * B, replacement=True, generator=gen)
        member = surv_cluster[None, :] == c2[:, None]                # (R*B, ns)
        member = member.reshape(R, 1, B, nsurv)
        score = torch.rand((R, 2, B, nsurv), generator=gen, dtype=f32, device=dev)
        jidx_local = torch.where(member, score, -1.0).argmax(dim=-1)
        cross = torch.rand((R, 1, B), generator=gen, dtype=f32, device=dev) < 0.25
        jidx = torch.where(cross, jidx, jidx_local)
    if cfg.canon_layout:
        w_trip = (
            cfg.move_mix[3]
            if len(cfg.move_mix) > 3
            else (w_white + w_de + w_axis) / 3.0
        )
    else:
        w_trip = 0.0
    tot = w_white + w_de + w_axis + w_trip
    r_mv = torch.rand((R, B, 1), generator=gen, dtype=f32, device=dev) * tot
    d_diff = surv_u[jidx[:, 0]] - surv_u[jidx[:, 1]]                # (R, B, d)
    de_ok = torch.linalg.vector_norm(d_diff, dim=-1, keepdim=True) > 1e-7
    axis_idx = torch.randint(0, ndim, (R, B), generator=gen, device=dev)
    d_axis = F.one_hot(axis_idx, ndim).to(f32)
    if cfg.canon_layout:
        startind, ncompmax, nfill = cfg.canon_layout[:3]
        tsel = torch.randint(
            0, ncompmax + max(nfill, 0), (R, B), generator=gen, device=dev
        )
        dim_ids = torch.arange(ndim, device=dev)
        trip_of_dim = torch.div(dim_ids - (startind + 1), 3, rounding_mode="floor")
        tmask = (trip_of_dim == tsel[..., None]) & (dim_ids >= startind + 1)
        d_trip = torch.where(tmask, d_diff, 0.0)
        trip_ok = torch.linalg.vector_norm(d_trip, dim=-1, keepdim=True) > 1e-7
    else:
        d_trip = d_diff
        trip_ok = de_ok
    return torch.where(
        (r_mv < w_de) & de_ok,
        d_diff,
        torch.where(
            r_mv < w_de + w_axis,
            d_axis,
            torch.where(
                (r_mv < w_de + w_axis + w_trip) & trip_ok, d_trip, d_white
            ),
        ),
    )


def slice_chains(
    loglike_batch, gen, u_start, logl_start, surv_u, surv_logl, lstar, cfg,
    *, surv_cluster=None,
):
    """Evolve B slice-sampling chains for ``cfg.num_repeats`` passes each
    under the hard constraint L > lstar.  Returns (u_new, logl_new,
    n_evals).  Every start point must satisfy the constraint.

    Passes are scheduled asynchronously: each iteration proposes one point
    per chain (one batched likelihood call); a chain that accepts, or
    exhausts ``max_shrink`` proposals, starts its next pass at once with
    its next pooled direction.  The loop runs until every chain has made
    ``num_repeats`` passes, with a hard ceiling of num_repeats * max_shrink
    iterations (num_repeats * (max_shrink + stepout_budget + 2) with the
    step-out bracket).  (:func:`_slice_stacked` with one problem.)"""
    _check_bracket(cfg)
    B = u_start.shape[0]
    pool_d = _direction_pool(gen, surv_u, surv_cluster, cfg, B)
    so = _stepout_pools(gen, cfg, B, u_start.device)
    u, logl, n_like = _slice_stacked(
        _one_problem(loglike_batch), [gen], u_start[None], logl_start[None],
        pool_d[None], torch.as_tensor(lstar).reshape(1), cfg, [0],
        so_pools=None if so is None else tuple(t[None] for t in so),
    )
    return u[0], logl[0], n_like[0]


def _one_problem(loglike_batch):
    """``loglike_batch`` as the likelihood of stacked rows of one problem
    (the problem indices ignored), under its own name."""
    @functools.wraps(loglike_batch)
    def rows(u, prob):
        return loglike_batch(u)

    return rows


def _check_bracket(cfg: NSConfig) -> None:
    if cfg.bracket not in ("chord", "stepout"):
        raise ValueError(f"unknown bracket {cfg.bracket!r}: expected 'chord' or 'stepout'")


def _stepout_pools(gen, cfg: NSConfig, B: int, device):
    """The step-out bracket's up-front draws, made after the direction
    pool's (None for the chord): chain i's pass p places its window at
    ``u01[p, i]`` (num_repeats, B) float32 and gives ``js[p, i]`` of its
    expansion budget (int32 in [0, m)) to the low end."""
    if cfg.bracket != "stepout":
        return None
    R = cfg.num_repeats
    u01 = torch.rand((R, B), generator=gen, dtype=torch.float32, device=device)
    js = torch.randint(0, int(cfg.stepout_budget), (R, B), generator=gen, device=device)
    return u01, js.to(torch.int32)


#: slice iterations per replayed CUDA graph (sampler/graph.py): a block
#: runs on for at most k - 1 iterations after the last chain's last pass,
#: and the host reads the loop's flags once per block (PERF.md has the
#: measured trade-off)
BLOCK_ITERATIONS = 16


class _Carry(NamedTuple):
    """The slice loop's state, updated in place by :func:`_slice_iter`."""

    u: torch.Tensor         # (Q, B, ndim) current points
    logl: torch.Tensor      # (Q, B)
    d: torch.Tensor         # (Q, B, ndim) direction of the current pass
    lo: torch.Tensor        # (Q, B) bracket along d
    hi: torch.Tensor        # (Q, B)
    it_pass: torch.Tensor   # (Q, B) int32 proposals in the current pass
    passes: torch.Tensor    # (Q, B) int32 passes made
    it_total: torch.Tensor  # () int32 iterations made
    n_like: torch.Tensor    # (Q,) int64 evaluations of problems with a pass to make


class _StepoutCarry(NamedTuple):
    """:class:`_Carry` with the step-out bracket's per-chain, per-pass
    state: the cube chord, the expansion budget left at each end, and the
    pass's phase (0: test and expand the low end, 1: the high end, 2:
    shrink)."""

    u: torch.Tensor
    logl: torch.Tensor
    d: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    it_pass: torch.Tensor
    passes: torch.Tensor
    it_total: torch.Tensor
    n_like: torch.Tensor
    clo: torch.Tensor       # (Q, B) cube chord along d
    chi: torch.Tensor       # (Q, B)
    jlo: torch.Tensor       # (Q, B) int32 expansions left at the low end
    jhi: torch.Tensor       # (Q, B) int32 at the high end
    phase: torch.Tensor     # (Q, B) int32


class _Fixed(NamedTuple):
    """What the slice loop reads and does not change, and its draw buffer."""

    loglike_rows: Callable
    gens: Sequence[torch.Generator]
    pools: torch.Tensor     # (Q, num_repeats, B, ndim) directions
    lstar: torch.Tensor     # (Q, 1) constraints
    rows: torch.Tensor      # (Q * B,) int32 problem index of each row
    r: torch.Tensor         # (Q, B) the iteration's uniform draws
    status: torch.Tensor    # (2, Q) int64: problem has a pass to make; n_like
    arange_q: torch.Tensor  # (Q, 1)
    arange_b: torch.Tensor  # (1, B)
    nrep: int
    total_cap: int
    max_shrink: int
    #: the step-out bracket's pools (:func:`_stepout_pools`, stacked to
    #: (Q, num_repeats, B)) and its width and budget; None for the chord
    u01: Optional[torch.Tensor] = None
    js: Optional[torch.Tensor] = None
    stepout: Optional[tuple] = None


def _fixed(loglike_rows, gens, pools, lstar, probs, cfg, so_pools=None) -> _Fixed:
    Q, nrep, B = pools.shape[:3]
    dev = pools.device
    stepout = None
    cap = nrep * int(cfg.max_shrink)
    if cfg.bracket == "stepout":
        if so_pools is None:
            raise ValueError("the step-out bracket needs its pools (u01, js)")
        m = int(cfg.stepout_budget)
        stepout = (float(cfg.stepout_w), m)
        cap = nrep * (int(cfg.max_shrink) + m + 2)
    return _Fixed(
        loglike_rows, list(gens), pools, lstar.reshape(Q, 1),
        torch.tensor(probs, dtype=torch.int32, device=dev).repeat_interleave(B),
        torch.zeros((Q, B), dtype=torch.float32, device=dev),
        torch.zeros((2, Q), dtype=torch.int64, device=dev),
        torch.arange(Q, device=dev)[:, None], torch.arange(B, device=dev)[None, :],
        nrep, cap, int(cfg.max_shrink),
        *((None, None) if stepout is None else so_pools), stepout,
    )


def _init_carry(u_start, logl_start, pools) -> _Carry:
    Q, B = logl_start.shape
    dev = u_start.device
    d = pools[:, 0].clone()
    lo, hi = _bracket(u_start, d)
    zeros = lambda: torch.zeros((Q, B), dtype=torch.int32, device=dev)
    return _Carry(
        u_start.clone(), logl_start.clone(), d, lo, hi, zeros(), zeros(),
        torch.zeros((), dtype=torch.int32, device=dev),
        torch.zeros((Q,), dtype=torch.int64, device=dev),
    )


def _start_pass(x: _Fixed, passes, u_cur):
    """The step-out window of each chain's pass ``passes`` from ``u_cur``:
    (d, lo, hi, clo, chi, jlo, jhi, phase).  The window of width w is
    placed uniformly around t = 0 first, then each end is clamped to the
    chord on its own: clamping lo before deriving hi would move the window
    off its uniform placement near a chord end and break the reversibility
    of Neal's interval procedure (the JAX package measured +0.12 nats on
    its Gaussian battery).  An end with no budget, or already at the chord,
    is not tested."""
    w, m = x.stepout
    idx = torch.clamp(passes, max=x.nrep - 1).long()
    d = x.pools[x.arange_q, idx, x.arange_b]
    clo, chi = _bracket(u_cur, d)
    lo0 = -x.u01[x.arange_q, idx, x.arange_b] * w
    lo = torch.maximum(lo0, clo)
    hi = torch.minimum(lo0 + w, chi)
    jlo = x.js[x.arange_q, idx, x.arange_b]
    jhi = (m - 1) - jlo
    phase = torch.where(
        (jlo > 0) & (lo > clo), 0, torch.where((jhi > 0) & (hi < chi), 1, 2)
    ).to(torch.int32)
    return d, lo, hi, clo, chi, jlo, jhi, phase


def _init_loop_carry(u_start, logl_start, x: _Fixed):
    """The carry at the loop's start: :func:`_init_carry`, or with the
    step-out bracket its first passes' windows."""
    c = _init_carry(u_start, logl_start, x.pools)
    if x.stepout is None:
        return c
    d, lo, hi, clo, chi, jlo, jhi, phase = _start_pass(x, c.passes, c.u)
    return _StepoutCarry(*c._replace(d=d, lo=lo, hi=hi), clo, chi, jlo, jhi, phase)


def _slice_iter(c, x: _Fixed, live=None) -> None:
    """One slice iteration of every chain, in place on ``c``: a uniform
    draw per problem from its generator into ``x.r``, then
    :func:`_slice_step`.  Every iteration draws exactly one (B,) batch per
    problem, in every phase of the step-out bracket too: the set-back of
    :class:`_SliceBlocks` counts on it.

    ``live``: None to draw for, and evaluate the rows of, every problem
    (the static shapes a CUDA graph replays; the rows of a problem that is
    done are evaluated and masked); or (problems, their index tensor, their
    rows) to draw for those alone and evaluate only their rows, as the
    eager loop does."""
    B = c.logl.shape[1]
    for q in range(c.logl.shape[0]) if live is None else live[0]:
        torch.rand((B,), generator=x.gens[q], dtype=torch.float32, device=c.u.device,
                   out=x.r[q])
    _slice_step(c, x, live)


def _slice_step(c, x: _Fixed, live=None) -> None:
    """One slice iteration of every chain from the draws in ``x.r``, in
    place on ``c``: one likelihood call, and the accept / shrink / next-pass
    bookkeeping (with the step-out bracket, the expansion of a window's
    ends first: a chain tests its low end, then its high end, then
    shrinks).  Where a problem has made all its passes, or the loop is past
    its cap, nothing moves: every phase's mask is false there, so the carry
    and ``n_like`` keep their values.  ``live`` as in :func:`_slice_iter`."""
    Q, B = c.logl.shape
    dev = c.u.device
    so = x.stepout is not None
    running = (c.passes < x.nrep) & (c.it_total < x.total_cap)
    active = running
    t = c.lo + x.r * (c.hi - c.lo)
    if so:
        t = torch.where(c.phase == 0, c.lo, torch.where(c.phase == 1, c.hi, t))
    u_prop = c.u + t[..., None] * c.d
    inside = ((u_prop >= 0.0) & (u_prop <= 1.0)).all(dim=-1)
    u_eval = torch.clamp(u_prop, 0.0, 1.0)
    if live is None or len(live[0]) == Q:
        ll_prop = x.loglike_rows(u_eval.reshape(Q * B, -1), x.rows).reshape(Q, B)
    else:
        qs, idx, rows = live
        ll_prop = torch.full((Q, B), -math.inf, dtype=torch.float32, device=dev)
        ll_prop[idx] = x.loglike_rows(u_eval[idx].reshape(len(qs) * B, -1), rows).reshape(-1, B)
    ll_prop = torch.where(inside, ll_prop, -math.inf)
    in_slice = ll_prop > x.lstar
    lo, hi = c.lo, c.hi
    if so:
        # Expansion: while the tested end lies in the slice and its budget
        # and the chord allow, it moves out by w; an end whose budget or
        # chord ran out right after a move is done without another test.
        w, _ = x.stepout
        p0 = running & (c.phase == 0)
        p1 = running & (c.phase == 1)
        grow_lo = p0 & in_slice & (c.jlo > 0) & (lo > c.clo)
        lo = torch.where(grow_lo, torch.maximum(lo - w, c.clo), lo)
        jlo = torch.where(grow_lo, c.jlo - 1, c.jlo)
        stop_lo = (p0 & ~grow_lo) | (grow_lo & ((jlo == 0) | (lo <= c.clo)))
        grow_hi = p1 & in_slice & (c.jhi > 0) & (hi < c.chi)
        hi = torch.where(grow_hi, torch.minimum(hi + w, c.chi), hi)
        jhi = torch.where(grow_hi, c.jhi - 1, c.jhi)
        stop_hi = (p1 & ~grow_hi) | (grow_hi & ((jhi == 0) | (hi >= c.chi)))
        phase = torch.where(
            stop_lo, torch.where((jhi > 0) & (hi < c.chi), 1, 2).to(torch.int32), c.phase
        )
        phase = torch.where(stop_hi, 2, phase).to(torch.int32)
        active = running & (c.phase == 2)  # shrinkage: the chord's own
    acc = in_slice & active
    u_cur = torch.where(acc[..., None], u_prop, c.u)
    logl_cur = torch.where(acc, ll_prop, c.logl)
    # Rejection shrinks the bracket toward the (unchanged) current point;
    # a chain that exhausts max_shrink proposals keeps its point.
    rej = active & ~acc
    it_pass = torch.where(rej, c.it_pass + 1, c.it_pass)
    lo = torch.where(rej & (t < 0), t, lo)
    hi = torch.where(rej & (t >= 0), t, hi)
    exhausted = rej & (it_pass >= x.max_shrink)
    fin = acc | exhausted
    passes = c.passes + fin.to(torch.int32)
    need = fin & (passes < x.nrep)
    if so:
        # the next pass starts from the new point
        d_new, lo_new, hi_new, clo_n, chi_n, jlo_n, jhi_n, ph_n = _start_pass(x, passes, u_cur)
        c.clo.copy_(torch.where(need, clo_n, c.clo))
        c.chi.copy_(torch.where(need, chi_n, c.chi))
        c.jlo.copy_(torch.where(need, jlo_n, jlo))
        c.jhi.copy_(torch.where(need, jhi_n, jhi))
        c.phase.copy_(torch.where(need, ph_n, phase))
    else:
        d_new = x.pools[x.arange_q, torch.clamp(passes, max=x.nrep - 1).long(), x.arange_b]
        lo_new, hi_new = _bracket(u_cur, d_new)
    c.d.copy_(torch.where(need[..., None], d_new, c.d))
    c.lo.copy_(torch.where(need, lo_new, lo))
    c.hi.copy_(torch.where(need, hi_new, hi))
    c.it_pass.copy_(torch.where(fin, 0, it_pass))
    c.u.copy_(u_cur)
    c.logl.copy_(logl_cur)
    c.passes.copy_(passes)
    c.n_like.add_(running.any(dim=1).to(torch.int64) * B)
    c.it_total.add_(1)


def _eager_loop(c: _Carry, x: _Fixed) -> None:
    """The slice loop one iteration at a time, with one host read per
    iteration of which problems still have a pass to make; a problem whose
    chains are all done stays done and leaves the batch."""
    Q, B = c.logl.shape
    live = (list(range(Q)), None, None)
    for _ in range(x.total_cap):
        running = (c.passes < x.nrep).any(dim=1).tolist()
        if not all(running[q] for q in live[0]):
            qs = [q for q in live[0] if running[q]]
            if not qs:
                break
            idx = torch.tensor(qs, device=c.u.device)
            live = (qs, idx, x.rows.reshape(Q, B)[idx].reshape(-1))
        _slice_iter(c, x, live)


def _block(c: _Carry, x: _Fixed, k: int) -> None:
    """k iterations of every chain, then the loop's status into
    ``x.status``: whether each problem has a pass left to make, and its
    evaluations."""
    for _ in range(k):
        _slice_iter(c, x)
    x.status[0].copy_(((c.passes < x.nrep) & (c.it_total < x.total_cap)).any(dim=1))
    x.status[1].copy_(c.n_like)


def _block_loop(x: _Fixed, k: int, run_block) -> List[int]:
    """Blocks of k iterations until no problem has a pass to make: the
    first num_repeats // k blocks without a host read (a chain makes at
    most one pass per iteration, so none can be done sooner; with the
    step-out bracket too, whose pass ends only in its shrink phase, so
    takes at least one iteration), then one read of the (2, Q) status
    after each block.  Returns each problem's evaluations."""
    from mcalf_torch.sampler.graph import count

    for _ in range(x.nrep // k):
        run_block()
    while True:
        run_block()
        running, n_like = x.status.tolist()
        count(reads=1)
        if not any(running):
            return n_like


class _SliceBlocks:
    """The slice loop of one set of stepping problems in blocks of k
    iterations, over buffers kept from one outer step to the next: the
    block replayed as a CUDA graph (``capture``), or run as it is.

    Every block draws for every problem, so afterwards each generator is
    set to where the eager loop leaves it: its state before the loop
    advanced by the draws of the iterations its problem ran (n_like / B).
    On a CUDA generator that is its Philox offset plus that many times the
    offset one iteration draws; elsewhere the draws are made again."""

    def __init__(self, loglike_rows, gens, probs, pools, cfg, k: int, capture: bool,
                 so_pools=None):
        self.x = _fixed(loglike_rows, gens, torch.empty_like(pools),
                        torch.empty((len(gens),), dtype=torch.float32, device=pools.device),
                        probs, cfg,
                        None if so_pools is None else tuple(map(torch.empty_like, so_pools)))
        self.k, self.capture = k, capture
        self.c = None
        self.graph = None

    def run(self, u_start, logl_start, pools, lstar, so_pools=None):
        x, k = self.x, self.k
        Q, B = logl_start.shape
        x.pools.copy_(pools)
        x.lstar.copy_(lstar.reshape(Q, 1))
        if x.stepout is not None:
            x.u01.copy_(so_pools[0])
            x.js.copy_(so_pools[1])
        c0 = _init_loop_carry(u_start, logl_start, x)
        if self.c is None:
            self.c = c0
        else:
            for dst, src in zip(self.c, c0):
                dst.copy_(src)
        c = self.c
        if self.capture and self.graph is None:
            from mcalf_torch.sampler.graph import BlockGraph

            self.graph = BlockGraph(
                lambda: _block(c, x, k),
                lambda: _slice_iter(type(c)(*(t.clone() for t in c)), x),
                x.gens, iterations=k,
                name=getattr(x.loglike_rows, "__qualname__", repr(x.loglike_rows)),
            )
        saved = [g.get_state() for g in x.gens]
        n_like = _block_loop(x, k, self.graph.replay if self.capture else lambda: _block(c, x, k))
        for q, g in enumerate(x.gens):
            g.set_state(saved[q])
            if self.capture:
                g.set_offset(g.get_offset() + n_like[q] // B * self.graph.draw_offset[q])
            else:
                for _ in range(n_like[q] // B):
                    torch.rand((B,), generator=g, dtype=torch.float32, device=x.r.device,
                               out=x.r[q])
        return c.u.clone(), c.logl.clone(), n_like


def _loop_kind(device: torch.device, loop: Optional[str]) -> str:
    """The slice loop a run takes: ``"graph"`` (blocks replayed as a CUDA
    graph) on a CUDA device, ``"eager"`` elsewhere, unless asked for
    ``"eager"`` or ``"blocks"`` (the graph's blocks, not captured)."""
    if loop is None:
        return "graph" if device.type == "cuda" else "eager"
    if loop not in ("eager", "blocks", "graph"):
        raise ValueError(f"unknown slice loop {loop!r}")
    if loop == "graph" and device.type != "cuda":
        raise ValueError(f"a CUDA graph runs on a CUDA device, not {device}")
    return loop


def _slice_stacked(loglike_rows, gens, u_start, logl_start, pools, lstar, cfg, probs,
                   *, loop=None, graphs=None, so_pools=None):
    """:func:`slice_chains` for Q problems at once: chains (Q, B, ndim) from
    ``u_start`` with ``logl_start`` (Q, B), directions ``pools`` (Q,
    num_repeats, B, ndim), constraints ``lstar`` (Q,), problem q's draws
    from ``gens[q]``.  ``loglike_rows(u, prob)`` takes (N, ndim) points
    and their (N,) int32 problem indices (``probs[q]`` for stacked problem
    q), so each iteration is one likelihood call over the rows of every
    problem.  Problem q's chains follow exactly the sequence of states and
    draws that :func:`slice_chains` gives it alone, and its generator ends
    where that run leaves it: the loop condition and the uniform draw are
    per problem.  ``so_pools``: the step-out bracket's (u01, js) pools, each
    (Q, num_repeats, B) (:func:`_stepout_pools`); None for the chord.

    ``loop`` (:func:`_loop_kind`): on a CUDA device the iterations run as
    replays of a CUDA graph of :data:`BLOCK_ITERATIONS` iterations,
    captured once per (stepping problems, B, ndim) and kept in ``graphs``
    (a dict the caller keeps for the run; None: this call's own) until
    another set steps: the set only shrinks, as problems finish, so a run
    holds one graph and its memory pool at a time; the
    eager loop (the CPU's) reads the host once per iteration and leaves
    a finished problem's rows out of the batch.
    Returns (u, logl, n_evals per problem)."""
    _check_bracket(cfg)
    loop = _loop_kind(u_start.device, loop)
    if loop == "eager":
        x = _fixed(loglike_rows, gens, pools, lstar, probs, cfg, so_pools)
        c = _init_loop_carry(u_start, logl_start, x)
        _eager_loop(c, x)
        return c.u, c.logl, c.n_like.tolist()
    graphs = {} if graphs is None else graphs
    key = (loop, tuple(probs), u_start.shape[1], u_start.shape[2])
    if key not in graphs:
        graphs.clear()
        graphs[key] = _SliceBlocks(loglike_rows, gens, probs, pools, cfg,
                                   BLOCK_ITERATIONS, capture=loop == "graph",
                                   so_pools=so_pools)
    return graphs[key].run(u_start, logl_start, pools, lstar, so_pools)


class _Head(NamedTuple):
    """One problem's outer step up to its slice chains (:func:`_head`)."""

    worst: torch.Tensor
    lstar: torch.Tensor
    logx: torch.Tensor
    logz: torch.Tensor
    dead_u: torch.Tensor
    dead_logl: torch.Tensor
    dead_logw: torch.Tensor
    dead_birth: torch.Tensor
    surv_logl: torch.Tensor
    surv_cluster: torch.Tensor
    start_idx: torch.Tensor
    u_start: torch.Tensor
    logl_start: torch.Tensor
    pool: torch.Tensor
    so_pool: Optional[tuple]  # the step-out bracket's (u01, js); None for the chord


def _head(s: NSState, cfg: NSConfig, gen, cum_dlogx) -> _Head:
    """Delete the B worst live points and draw what the replacements need:
    start survivors, the direction pool and (step-out) the windows' pools."""
    nlive, B = cfg.nlive, cfg.num_delete
    dev = s.live_u.device

    # ---- delete the B worst live points (stable order, as jnp.argsort) ---
    order = torch.argsort(s.live_logl, stable=True)
    worst = order[:B]
    surv = order[B:]
    dead_logl_new = s.live_logl[worst]
    dead_u_new = s.live_u[worst]
    # Constraint: strictly above the HIGHEST deleted point, L > L*_(B).
    lstar = dead_logl_new[-1]

    logx_seq = s.logx + cum_dlogx                                # (B,)
    logx_prev = torch.cat([s.logx[None], logx_seq[:-1]])
    logw_new = logx_prev + torch.log1p(-torch.exp(logx_seq - logx_prev))
    logz = torch.logaddexp(
        s.logz, torch.logsumexp(logw_new + dead_logl_new, dim=0)
    )

    nd = s.n_dead
    dead_u = s.dead_u.clone()
    dead_u[nd : nd + B] = dead_u_new
    dead_logl = s.dead_logl.clone()
    dead_logl[nd : nd + B] = dead_logl_new
    dead_logw = s.dead_logw.clone()
    dead_logw[nd : nd + B] = logw_new
    dead_birth = s.dead_birth.clone()
    dead_birth[nd : nd + B] = s.live_birth[worst]

    # ---- replacements: slice chains from a random B-subset of survivors,
    # without replacement (tiled evenly when B > nsurv) --------------------
    surv_u = s.live_u[surv]
    surv_logl = s.live_logl[surv]
    nsurv = nlive - B
    if B <= nsurv:
        start_idx = torch.randperm(nsurv, generator=gen, device=dev)[:B]
    else:
        tiled = torch.arange(nsurv, device=dev).repeat(-(-B // nsurv))
        perm = torch.randperm(tiled.numel(), generator=gen, device=dev)
        start_idx = tiled[perm][:B]
    surv_cluster = s.live_cluster[surv]
    return _Head(
        worst=worst, lstar=lstar, logx=logx_seq[-1], logz=logz, dead_u=dead_u,
        dead_logl=dead_logl, dead_logw=dead_logw, dead_birth=dead_birth,
        surv_logl=surv_logl, surv_cluster=surv_cluster, start_idx=start_idx,
        u_start=surv_u[start_idx], logl_start=surv_logl[start_idx],
        pool=_direction_pool(gen, surv_u, surv_cluster, cfg, B),
        so_pool=_stepout_pools(gen, cfg, B, dev),
    )


def _tail(s: NSState, h: _Head, u_new, logl_new, n_evals: int, cfg: NSConfig, gen) -> NSState:
    """Insertion ranks of the replacements and the rebuilt live set."""
    B = cfg.num_delete
    dev = s.live_u.device
    nd = s.n_dead

    # ---- insertion ranks among the survivors, ties broken at random ------
    nless = torch.sum(h.surv_logl[None, :] < logl_new[:, None], dim=1)
    nties = torch.sum(h.surv_logl[None, :] == logl_new[:, None], dim=1)
    tie_pos = torch.floor(
        torch.rand((B,), generator=gen, dtype=torch.float32, device=dev)
        * (nties + 1).to(torch.float32)
    ).to(nties.dtype)
    ranks = (nless + torch.minimum(tie_pos, nties)).to(torch.int32)
    dead_rank = s.dead_rank.clone()
    dead_rank[nd : nd + B] = ranks

    # ---- rebuild the live set (gauge-fixed) -------------------------------
    live_u = s.live_u.clone()
    live_u[h.worst] = u_new
    live_u = _canon_live(live_u, cfg)
    live_logl = s.live_logl.clone()
    live_logl[h.worst] = logl_new
    live_birth = s.live_birth.clone()
    live_birth[h.worst] = h.lstar
    # A replacement inherits its start survivor's cluster until the next
    # host re-clustering.
    live_cluster = s.live_cluster.clone()
    live_cluster[h.worst] = h.surv_cluster[h.start_idx]

    return NSState(
        live_u=live_u,
        live_logl=live_logl,
        live_birth=live_birth,
        dead_u=h.dead_u,
        dead_logl=h.dead_logl,
        dead_logw=h.dead_logw,
        dead_birth=h.dead_birth,
        n_dead=nd + B,
        logx=h.logx,
        logz=h.logz,
        n_like=s.n_like + n_evals,
        step=s.step + 1,
        dead_rank=dead_rank,
        live_cluster=live_cluster,
    )


def _steps(loglike_rows, states, gens, probs, cfg: NSConfig, cum_dlogx, loop=None,
           graphs=None):
    """One outer step of each of several problems: each problem's head on
    its own generator, their slice chains stacked, each problem's tail.
    Problem q's new state is the one its step alone would give.  ``loop``,
    ``graphs``: see :func:`_slice_stacked`."""
    heads = [_head(s, cfg, g, cum_dlogx) for s, g in zip(states, gens)]
    u_new, logl_new, n_evals = _slice_stacked(
        loglike_rows, gens,
        torch.stack([h.u_start for h in heads]),
        torch.stack([h.logl_start for h in heads]),
        torch.stack([h.pool for h in heads]),
        torch.stack([h.lstar for h in heads]),
        cfg, probs, loop=loop, graphs=graphs,
        so_pools=None if heads[0].so_pool is None else tuple(
            torch.stack(t) for t in zip(*(h.so_pool for h in heads))),
    )
    return [
        _tail(s, h, u_new[i], logl_new[i], n_evals[i], cfg, g)
        for i, (s, h, g) in enumerate(zip(states, heads, gens))
    ]


def _cum_dlogx(cfg: NSConfig, device) -> torch.Tensor:
    # Sequential shrinkage of a batch of B deletions: d ln X_j = -1/(nlive-j).
    dlogx = -1.0 / (
        cfg.nlive - torch.arange(cfg.num_delete, dtype=torch.float32, device=device)
    )
    return torch.cumsum(dlogx, dim=0)


def run_steps(
    loglike_batch, state: NSState, config: NSConfig, num_steps: int,
    gen: torch.Generator,
) -> NSState:
    """Advance until termination or ``num_steps`` further outer steps."""
    cfg = config.resolved()
    cum_dlogx = _cum_dlogx(cfg, state.live_u.device)
    ll = _one_problem(loglike_batch)
    graphs = {}
    for _ in range(int(num_steps)):
        if not _not_done(state, cfg):
            break
        state = _steps(ll, [state], [gen], [0], cfg, cum_dlogx, graphs=graphs)[0]
    return state


def finalize(final: NSState, config: NSConfig) -> NSResults:
    """Fold the live set in (uniform weights X_final / nlive) and assemble
    :class:`NSResults` (tensors on the state's device)."""
    cfg = config.resolved()
    nlive, cap = cfg.nlive, int(cfg.max_samples)
    dev = final.live_u.device
    f32 = torch.float32

    live_logw = torch.full(
        (nlive,), 0.0, dtype=f32, device=dev
    ) + (final.logx - math.log(np.float32(nlive)))
    logz = torch.logaddexp(
        final.logz, torch.logsumexp(live_logw + final.live_logl, dim=0)
    )
    samples_u = torch.cat([final.dead_u, final.live_u], dim=0)
    logl = torch.cat([final.dead_logl, final.live_logl])
    logw = torch.cat([final.dead_logw, live_logw])
    birth = torch.cat([final.dead_birth, final.live_birth])
    valid = torch.cat(
        [
            torch.arange(cap, device=dev) < final.n_dead,
            torch.ones((nlive,), dtype=torch.bool, device=dev),
        ]
    )
    logw = torch.where(valid, logw, -math.inf)
    logl_safe = torch.where(valid, logl, 0.0)
    log_post = logw + torch.where(valid, logl, -math.inf) - logz
    # Information H = sum p_i ln L_i - ln Z -> logzerr = sqrt(H / nlive),
    # with ln L_max taken out of both terms first: at |ln L| ~ 1e5 the two
    # float32 terms are equal to within their rounding and H would cancel
    # to <= 0.
    lmax = torch.max(torch.where(valid, logl, -math.inf))
    p = torch.exp(log_post)
    h = torch.sum(torch.where(valid, p * (logl_safe - lmax), 0.0)) - (logz - lmax)
    logzerr = torch.sqrt(torch.clamp(h, min=0.0) / nlive)
    converged = bool(
        _remaining_logz(final, nlive) - logz
        <= torch.log(_f32(cfg.precision_criterion, dev))
    )
    return NSResults(
        logz=logz,
        logzerr=logzerr,
        h=h,
        samples_u=samples_u,
        logl=logl,
        logw=logw,
        birth_logl=birth,
        log_posterior_weights=log_post,
        n_dead=final.n_dead + nlive,
        n_like=final.n_like,
        n_iter=final.step,
        termination_reason=0 if converged else 1,
        insertion_rank=torch.cat(
            [
                final.dead_rank,
                torch.full((nlive,), -1, dtype=torch.int32, device=dev),
            ]
        ),
    )


def _restore_generator(gen: torch.Generator, rng: torch.Tensor) -> None:
    """Put a saved generator state back.  A CPU generator's state and a CUDA
    generator's differ in size, so a state saved on one device type cannot
    continue on the other."""
    if rng.numel() != gen.get_state().numel():
        raise ValueError(
            f"the saved generator state ({rng.numel()} bytes) is not one of a "
            f"{gen.device.type} generator ({gen.get_state().numel()} bytes): a "
            "sampler state resumes only on the device type it was saved on"
        )
    # a copy: set_state reads a row of a stacked state's (Q, bytes) tensor
    # from the start of its storage
    gen.set_state(rng.to(torch.uint8).cpu().clone())


def nested_sample(
    loglike_batch: Callable,
    gen: torch.Generator,
    config: NSConfig,
    device: "torch.device | str",
    state: Optional[NSState] = None,
    return_state: bool = False,
    chunk_steps: Optional[int] = None,
    on_chunk: Optional[Callable[[NSState], None]] = None,
    *,
    _loop: Optional[str] = None,
):
    """Run nested sampling on ``device``, stepping in chunks of outer steps
    from a host loop; the live set is re-clustered at every chunk boundary.

    The first boundary comes after 8 steps, then every ``chunk_steps``
    (default :data:`DEFAULT_CHUNK_STEPS`) outer steps; an explicit
    ``chunk_steps`` applies from the start.  The schedule is fixed in outer
    steps, so a run resumed from a state that ``on_chunk`` was handed meets
    the same boundaries, and ends bit for bit, as the uninterrupted run.

    Parameters
    ----------
    loglike_batch : callable (B, ndim) unit-cube float32 tensor -> (B,)
    gen : torch.Generator on ``device``; every random draw comes from it
    config : NSConfig
    device : where the live set, the dead buffers and the draws live
    state : resume from this NSState (a loaded checkpoint) instead of
        drawing fresh live points; ``gen`` is set to the state's ``rng``
        when it carries one, else ``gen`` goes on from where it stands
    return_state : also return the final NSState
    on_chunk : optional host callback with the NSState after every chunk;
        that state holds the generator's state, so it can be saved and
        resumed

    Returns NSResults (tensors on ``device``; ``.numpy()`` copies them to
    the host), or (NSResults, NSState) when ``return_state``.
    (:func:`nested_sample_stacked` with one problem.)
    """
    cfg = config.resolved()
    [final] = nested_sample_stacked(
        _one_problem(loglike_batch), [gen], cfg, device,
        states=None if state is None else [state],
        chunk_steps=chunk_steps,
        on_chunk=None if on_chunk is None else (lambda states: on_chunk(states[0])),
        _loop=_loop,
    )
    results = finalize(final, cfg)
    return (results, final) if return_state else results


def nested_sample_stacked(
    loglike_rows: Callable,
    gens: Sequence[torch.Generator],
    config: NSConfig,
    device: "torch.device | str",
    states: Optional[Sequence[NSState]] = None,
    chunk_steps: Optional[int] = None,
    on_chunk: Optional[Callable[[List[NSState]], None]] = None,
    *,
    _loop: Optional[str] = None,
) -> List[NSState]:
    """Run Q independent nested-sampling problems together, one generator
    each, and return their final states.

    Every outer step stacks the slice chains of all problems still running
    (:func:`_slice_stacked`), so a slice iteration is one call of
    ``loglike_rows(u, prob)`` -- (N, ndim) unit-cube points and their (N,)
    int32 problem indices -- for every problem at once.  Each problem keeps
    its own termination check, its own chunk schedule and re-clustering (as
    :func:`nested_sample`'s), and its own draws, in the order its solo run
    makes them: problem q ends in the state ``nested_sample`` gives it with
    generator ``gens[q]``, whatever the other problems do.  A problem that
    is done leaves the stack.

    ``states``: resume from these per-problem states (each generator set to
    its state's ``rng`` where it carries one).  ``on_chunk(states)``: called
    with the list of every problem's state whenever no problem is inside a
    chunk (all at a boundary or done), so the list can be saved and
    resumed.

    On a CUDA device the slice iterations run as replays of CUDA graphs
    captured once per set of stepping problems for the run
    (:func:`_slice_stacked`); ``_loop="eager"`` asks for the loop of one
    host read per iteration instead (the CPU's)."""
    cfg = config.resolved()
    _check_bracket(cfg)
    Q = len(gens)
    if states is None:
        live_u = [_draw_live(g, cfg, device) for g in gens]
        rows = torch.arange(Q, dtype=torch.int32, device=device).repeat_interleave(cfg.nlive)
        live_logl = loglike_rows(torch.cat(live_u), rows).reshape(Q, cfg.nlive)
        states = [_fresh_state(u, l, cfg) for u, l in zip(live_u, live_logl)]
    else:
        states = list(states)
        for s, g in zip(states, gens):
            if s.rng is not None:
                _restore_generator(g, s.rng)
    if len(states) != Q:
        raise ValueError(f"{len(states)} states for {Q} generators")
    cum_dlogx = _cum_dlogx(cfg, states[0].live_u.device)
    chunk = DEFAULT_CHUNK_STEPS if chunk_steps is None else int(chunk_steps)
    # A state past step 0 has its 8-step probe behind it.
    first = [chunk_steps is None and s.step == 0 for s in states]
    left = [None] * Q  # outer steps left in each problem's chunk, None between chunks
    done = [False] * Q
    graphs = {}  # the run's captured slice loops
    # The host touches a run only here, between chunks.
    while True:
        for q in range(Q):
            if left[q] is None and not done[q]:
                if is_done(states[q], cfg):
                    done[q] = True
                    continue
                states[q] = _recluster(states[q], cfg)
                left[q] = _PROBE_STEPS if first[q] else chunk
                first[q] = False
        inside = [q for q in range(Q) if left[q] is not None]
        if not inside:
            break
        stepping = [q for q in inside if left[q] > 0 and _not_done(states[q], cfg)]
        if stepping:
            new = _steps(loglike_rows, [states[q] for q in stepping],
                         [gens[q] for q in stepping], stepping, cfg, cum_dlogx,
                         _loop, graphs)
            for q, s in zip(stepping, new):
                states[q] = s
                left[q] -= 1
        ended = [q for q in inside if q not in stepping or left[q] == 0]
        for q in ended:  # these problems' chunks end
            states[q] = states[q]._replace(rng=gens[q].get_state())
            left[q] = None
        if on_chunk is not None and ended and all(x is None for x in left):
            on_chunk(list(states))
    return states


