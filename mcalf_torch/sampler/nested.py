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
  the exact cube-chord bracket and the hard constraint L > L* (the highest
  deleted likelihood).  Chains advance their passes asynchronously: one
  batched likelihood call per iteration, each chain moving on to its next
  pass as soon as it accepts.
* Termination when the live set's remaining evidence falls below
  ``precision_criterion`` of the accumulated one, or at ``max_samples``.

What differs from the JAX package is the PyTorch idiom: every random draw
comes from an explicit ``torch.Generator`` (the numbers are therefore not
``jax.random``'s), the loops are eager Python loops (one host
synchronisation per slice iteration, for the loop condition), and the
state carries its scalar counters as Python ints.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

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
    "nsstate_from_numpy",
    "nsstate_to_numpy",
    "run_steps",
    "slice_chains",
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
    #: bracket strategy: only "chord" (the exact cube chord) is ported
    bracket: str = "chord"
    stepout_w: float = 2.0
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
    ndim, nlive, cap = cfg.ndim, cfg.nlive, int(cfg.max_samples)
    f32 = torch.float32
    live_u = _canon_live(
        torch.rand((nlive, ndim), generator=gen, dtype=f32, device=device), cfg
    )
    live_logl = loglike_batch(live_u)
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
        n_dead=int(np.asarray(d["n_dead"])),
        logx=t("logx", f32),
        logz=t("logz", f32),
        n_like=int(np.asarray(d["n_like"])),
        step=int(np.asarray(d["step"])),
        dead_rank=t("dead_rank", torch.int32),
        live_cluster=t("live_cluster", torch.int64),
        rng=(
            torch.from_numpy(np.array(d["rng"], dtype=np.uint8))
            if d.get("rng") is not None else None
        ),
    )


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
    iterations."""
    if cfg.bracket != "chord":
        raise NotImplementedError(
            f"bracket={cfg.bracket!r} is not ported (only the cube chord); "
            "ROADMAP Queue 1: stepout bracket and reference_style"
        )
    B = u_start.shape[0]
    dev = u_start.device
    nrep = int(cfg.num_repeats)
    total_cap = nrep * int(cfg.max_shrink)
    pool_d = _direction_pool(gen, surv_u, surv_cluster, cfg, B)
    arange_b = torch.arange(B, device=dev)

    u_cur, logl_cur = u_start, logl_start
    d = pool_d[0]
    lo, hi = _bracket(u_cur, d)
    it_pass = torch.zeros((B,), dtype=torch.int32, device=dev)
    passes = torch.zeros((B,), dtype=torch.int32, device=dev)
    n_like = 0
    it_total = 0
    while it_total < total_cap and bool((passes < nrep).any()):
        active = passes < nrep
        t = lo + torch.rand((B,), generator=gen, dtype=torch.float32, device=dev) * (
            hi - lo
        )
        u_prop = u_cur + t[:, None] * d
        inside = ((u_prop >= 0.0) & (u_prop <= 1.0)).all(dim=1)
        ll_prop = loglike_batch(torch.clamp(u_prop, 0.0, 1.0))
        ll_prop = torch.where(inside, ll_prop, -math.inf)
        acc = (ll_prop > lstar) & active
        u_cur = torch.where(acc[:, None], u_prop, u_cur)
        logl_cur = torch.where(acc, ll_prop, logl_cur)
        # Rejection shrinks the bracket toward the (unchanged) current point;
        # a chain that exhausts max_shrink proposals keeps its point.
        rej = active & ~acc
        it_pass = torch.where(rej, it_pass + 1, it_pass)
        lo = torch.where(rej & (t < 0), t, lo)
        hi = torch.where(rej & (t >= 0), t, hi)
        exhausted = rej & (it_pass >= cfg.max_shrink)
        fin = acc | exhausted
        passes = passes + fin.to(torch.int32)
        need = fin & (passes < nrep)
        d_new = pool_d[torch.clamp(passes, max=nrep - 1).long(), arange_b]
        lo_new, hi_new = _bracket(u_cur, d_new)
        d = torch.where(need[:, None], d_new, d)
        lo = torch.where(need, lo_new, lo)
        hi = torch.where(need, hi_new, hi)
        it_pass = torch.where(fin, 0, it_pass)
        n_like += B
        it_total += 1
    return u_cur, logl_cur, n_like


def _step(loglike_batch, s: NSState, cfg: NSConfig, gen, cum_dlogx) -> NSState:
    """One outer step: delete the B worst, replace them by slice sampling."""
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
    u_cur = surv_u[start_idx]
    logl_cur = surv_logl[start_idx]
    surv_cluster = s.live_cluster[surv]
    u_new, logl_new, n_evals = slice_chains(
        loglike_batch, gen, u_cur, logl_cur, surv_u, surv_logl, lstar, cfg,
        surv_cluster=surv_cluster,
    )

    # ---- insertion ranks among the survivors, ties broken at random ------
    nless = torch.sum(surv_logl[None, :] < logl_new[:, None], dim=1)
    nties = torch.sum(surv_logl[None, :] == logl_new[:, None], dim=1)
    tie_pos = torch.floor(
        torch.rand((B,), generator=gen, dtype=torch.float32, device=dev)
        * (nties + 1).to(torch.float32)
    ).to(nties.dtype)
    ranks = (nless + torch.minimum(tie_pos, nties)).to(torch.int32)
    dead_rank = s.dead_rank.clone()
    dead_rank[nd : nd + B] = ranks

    # ---- rebuild the live set (gauge-fixed) -------------------------------
    live_u = s.live_u.clone()
    live_u[worst] = u_new
    live_u = _canon_live(live_u, cfg)
    live_logl = s.live_logl.clone()
    live_logl[worst] = logl_new
    live_birth = s.live_birth.clone()
    live_birth[worst] = lstar
    # A replacement inherits its start survivor's cluster until the next
    # host re-clustering.
    live_cluster = s.live_cluster.clone()
    live_cluster[worst] = surv_cluster[start_idx]

    return NSState(
        live_u=live_u,
        live_logl=live_logl,
        live_birth=live_birth,
        dead_u=dead_u,
        dead_logl=dead_logl,
        dead_logw=dead_logw,
        dead_birth=dead_birth,
        n_dead=nd + B,
        logx=logx_seq[-1],
        logz=logz,
        n_like=s.n_like + n_evals,
        step=s.step + 1,
        dead_rank=dead_rank,
        live_cluster=live_cluster,
    )


def run_steps(
    loglike_batch, state: NSState, config: NSConfig, num_steps: int,
    gen: torch.Generator,
) -> NSState:
    """Advance until termination or ``num_steps`` further outer steps."""
    cfg = config.resolved()
    nlive, B = cfg.nlive, cfg.num_delete
    # Sequential shrinkage of a batch of B deletions: d ln X_j = -1/(nlive-j).
    dlogx = -1.0 / (
        nlive - torch.arange(B, dtype=torch.float32, device=state.live_u.device)
    )
    cum_dlogx = torch.cumsum(dlogx, dim=0)
    for _ in range(int(num_steps)):
        if not _not_done(state, cfg):
            break
        state = _step(loglike_batch, state, cfg, gen, cum_dlogx)
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
    # Information H = sum p_i ln L_i - ln Z -> logzerr = sqrt(H / nlive)
    p = torch.exp(log_post)
    h = torch.sum(torch.where(valid, p * logl_safe, 0.0)) - logz
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
    gen.set_state(rng.to(torch.uint8).cpu())


def nested_sample(
    loglike_batch: Callable,
    gen: torch.Generator,
    config: NSConfig,
    device: "torch.device | str",
    state: Optional[NSState] = None,
    return_state: bool = False,
    chunk_steps: Optional[int] = None,
    on_chunk: Optional[Callable[[NSState], None]] = None,
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
    """
    cfg = config.resolved()
    if state is None:
        state = init_state(loglike_batch, gen, cfg, device)
    elif state.rng is not None:
        _restore_generator(gen, state.rng)
    # A state past step 0 has its 8-step probe behind it.
    first = chunk_steps is None and state.step == 0
    chunk = DEFAULT_CHUNK_STEPS if chunk_steps is None else int(chunk_steps)
    # The host touches the run only here, between chunks.
    while not is_done(state, cfg):
        state = _recluster(state, cfg)
        steps = _PROBE_STEPS if first else chunk
        first = False
        state = run_steps(loglike_batch, state, cfg, steps, gen)
        state = state._replace(rng=gen.get_state())
        if on_chunk is not None:
            on_chunk(state)
    results = finalize(state, cfg)
    return (results, state) if return_state else results
