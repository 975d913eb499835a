"""Live-point mode clustering (PolyChord ``do_clustering`` role).

The reference's default PolyChord run has ``do_clustering=True``
(mcalf/cli.py:95) and its MultiNest backend is
ellipsoidal/multimodal (cli.py:179-182): both recognize when the
constrained-prior region fragments into separated modes (for absorption
fits: alternative redshift solutions for the same lines) and adapt the
proposal geometry per mode.  This module is the host-side half: a cheap,
deterministic recursive 2-means in whitened space, run at chunk boundaries
(once per ~hundreds of likelihood batches), whose labels feed the
per-cluster direction mixture in
:func:`mcalf_torch.sampler.nested.slice_chains`.

A numpy copy of :mod:`mcalf_tpu.sampler.clusters` (importing the original
pulls jax in through ``mcalf_tpu.sampler.__init__``); the tests hold it
equal to the original.

The split-acceptance test is a 1-D bimodality check along the centroid
axis: accept a 2-means split only when the two groups' projections are
separated by more than ``sep`` times the sum of their spreads.  A single
Gaussian split in half has gap ~1.6 sigma vs spreads ~0.6+0.6 sigma, so
``sep=2`` never splits a unimodal cloud but fires from ~4-sigma mode
separation up.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

__all__ = ["assign_clusters", "ClusterReport", "posterior_cluster_report"]


def _two_means(x: np.ndarray, iters: int = 12) -> np.ndarray:
    """Deterministic 2-means: seeds are the extreme points along the top
    principal axis; returns a boolean membership of group 1."""
    c = x - x.mean(axis=0)
    # top principal direction via a few power iterations (cheap, no SVD)
    v = c.std(axis=0) + 1e-12
    for _ in range(8):
        v = c.T @ (c @ v)
        v = v / (np.linalg.norm(v) + 1e-30)
    proj = c @ v
    m0, m1 = x[np.argmin(proj)], x[np.argmax(proj)]
    lab = np.zeros(x.shape[0], bool)
    for _ in range(iters):
        d0 = ((x - m0) ** 2).sum(axis=1)
        d1 = ((x - m1) ** 2).sum(axis=1)
        new = d1 < d0
        if np.array_equal(new, lab):
            break
        lab = new
        if lab.any():
            m1 = x[lab].mean(axis=0)
        if (~lab).any():
            m0 = x[~lab].mean(axis=0)
    return lab


def _split_ok(x: np.ndarray, lab: np.ndarray, sep: float) -> bool:
    """Accept the split only for genuine bimodality along the centroid
    axis (see module docstring)."""
    a, b = x[~lab], x[lab]
    if len(a) < 2 or len(b) < 2:
        return False
    e = b.mean(axis=0) - a.mean(axis=0)
    norm = np.linalg.norm(e)
    if norm < 1e-12:
        return False
    e = e / norm
    pa, pb = a @ e, b @ e
    gap = pb.mean() - pa.mean()
    return gap > sep * (pa.std() + pb.std() + 1e-12)


def assign_clusters(
    u: np.ndarray,
    max_clusters: int = 8,
    min_size: int = 5,
    sep: float = 2.0,
) -> Tuple[np.ndarray, int]:
    """Cluster points by recursive 2-means in globally whitened space.

    Returns ``(labels, k)`` with labels int32 in [0, k), ordered by
    decreasing cluster size.  Deterministic (no RNG).
    """
    u = np.asarray(u, np.float64)
    n = u.shape[0]
    if n < 2 * min_size or max_clusters <= 1:
        return np.zeros(n, np.int32), 1
    # whiten globally so the separation criterion is scale-free per dim
    mu = u.mean(axis=0)
    sd = u.std(axis=0) + 1e-12
    x = (u - mu) / sd

    groups: List[np.ndarray] = [np.arange(n)]
    final: List[np.ndarray] = []
    while groups:
        idx = groups.pop()
        if (
            len(final) + len(groups) + 1 >= max_clusters
            or len(idx) < 2 * min_size
        ):
            final.append(idx)
            continue
        lab = _two_means(x[idx])
        if (
            lab.sum() >= min_size
            and (~lab).sum() >= min_size
            and _split_ok(x[idx], lab, sep)
        ):
            groups.append(idx[~lab])
            groups.append(idx[lab])
        else:
            final.append(idx)
    final.sort(key=len, reverse=True)
    labels = np.zeros(n, np.int32)
    for k, idx in enumerate(final):
        labels[idx] = k
    return labels, len(final)


class ClusterReport(NamedTuple):
    #: number of posterior modes found
    k: int
    #: (k,) posterior mass fraction of each mode, decreasing
    mass: np.ndarray
    #: (k, ndim) posterior-mean unit-cube position of each mode
    mean_u: np.ndarray
    #: (n,) mode label of each equal-weight posterior draw
    labels: np.ndarray
    #: (n, ndim) the equal-weight posterior draws the report is built from
    samples_u: np.ndarray


def posterior_cluster_report(
    results, n: int = 2000, max_clusters: int = 8, seed: int = 0
) -> ClusterReport:
    """Per-mode posterior readout (the MultiNest 'multimodal' summary role):
    equal-weight-resample the posterior, cluster the draws, and report each
    mode's mass fraction and mean.

    Works on NSResults and MergedRun alike (anything with ``samples_u`` and
    ``log_posterior_weights``)."""
    logp = np.asarray(results.log_posterior_weights, np.float64).ravel()
    su = np.asarray(results.samples_u, np.float64)
    valid = np.isfinite(logp)
    logp, su = logp[valid], su[valid]
    w = np.exp(logp - logp.max())
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    pick = rng.choice(logp.size, size=n, p=w)
    s = su[pick]
    labels, k = assign_clusters(s, max_clusters=max_clusters)
    mass = np.bincount(labels, minlength=k).astype(np.float64) / n
    mean_u = np.stack(
        [s[labels == i].mean(axis=0) for i in range(k)], axis=0
    )
    return ClusterReport(k=k, mass=mass, mean_u=mean_u, labels=labels,
                         samples_u=s)
