"""Plain float64 reference of the fit's log-likelihood (numpy and scipy).

It reads a fit configuration (``.cfg``) and its spectrum as the fitter's
configuration format defines them, and works out again everything the
fitter derives from them: the pixels inside ``wavefit``, the velocity step,
the prior box and parameter layout, the redshift midpoints, the Gaussian
line-spread function and its taps, and the active components of each row.
The Voigt function is ``scipy.special.wofz``; everything is float64.

The model, for a unit-cube row u (parameter layout
``[specres] [cont] [ncomp] [N, z, b] * ncompmax [N, z, b] * nfill``, the
first two slots only where ``[input] specres`` or ``[components] contval``
is a range ``lo, hi``: upstream ``hires_fitter.py:54-62,168-200``):

* p = lo + u (hi - lo); the active component count is floor(p[startind])
  of the float32 transform (the sampled ncomp slot is a float32 number in
  the stated model; its floor is the only discrete choice in the
  likelihood), with ``startind`` the number of the free slots before it;
* tau(pixel) = sum over active components and their transitions, and every
  filler, of TAU_CONST 10^N f / dnu * Re w((nu(1+z) - nu0)/dnu + i a),
  with dnu = b / lambda0 and a = gamma / (4 pi dnu);
* model = cont * LSF(exp(-tau)) with the LSF zero-padded and its ``half``
  edge pixels on each side left unconvolved.  The LSF is a Gaussian of
  FWHM ``specres`` sampled at k = -half .. half pixels and normalised to
  sum 1; ``half`` is set by the largest FWHM the prior admits (upstream
  ``hires_fitter.py:548-560``).  A free resolution gives each row its own
  taps from its own FWHM, a free continuum its own cont;
* log L = -1/2 sum over valid pixels of ivar (data - model)^2 - log ivar +
  log 2 pi;
* with ``[input] asymmlike``, log L is -inf where the valid pixels whose
  residual (data - model) / noise exceeds 5 number more than npix
  Phi(-5) + npix / 100, or those above 4 more than npix Phi(-4) + npix / 100
  (upstream ``hires_fitter.py:296-302``).  Upstream takes the expected
  counts from an unseeded draw of npix standard normals
  (``hires_fitter.py:179-181``), so its limits change from run to run; this
  reference takes the deterministic expectation npix Phi(-k), as the port
  does (``mcalf_torch/models/forward.py:249-258``).

``[components] gpriors`` is refused: upstream reaches it only from a dead
path (``hires_fitter.py:218-234``), and no live solver applies it.
``lines.json`` beside this file is a frozen copy of the transitions'
atomic data.  Nothing here imports the fitter.
"""

from __future__ import annotations

import configparser
import json
import math
from pathlib import Path
from typing import List, Tuple

import numpy as np
from scipy.special import ndtr, wofz

CCGS = 2.9979245e10
CLIGHT_KMS = 2.9979245e5
TAU_CONST = 0.014971475
#: a filler line is the first target line moved to this rest wavelength
FILLER_WREST = 250.0
FWHM_TO_SIGMA = 2.354820
SUPPORT_SIGMAS = 3.0348

_LINES = json.loads((Path(__file__).with_name("lines.json")).read_text())


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split(",")], np.float64)


def _pair(a) -> Tuple[float, float]:
    a = np.atleast_1d(np.asarray(a, np.float64))
    return (float(a[0]), float(a[-1])) if a.size > 1 else (float(a[0]), float(a[0]))


def read_spectrum(path: str, coldef: List[str]) -> Tuple[np.ndarray, ...]:
    """The columns ``coldef`` of a whitespace table whose names are on a
    ``#`` header line."""
    names = None
    with open(path) as fh:
        for line in fh:
            s = line.strip()
            if s.startswith("#"):
                names = s.lstrip("#").split()
                continue
            break
    data = np.loadtxt(path, comments="#", ndmin=2)
    if names is None or len(names) != data.shape[1]:
        raise ValueError(f"{path}: no header naming its {data.shape[1]} columns")
    return tuple(data[:, names.index(c)].astype(np.float64) for c in coldef)


def velocity_step(wave: np.ndarray, sigma: float = 3.0, maxiters: int = 5) -> float:
    """Median km/s per pixel after iterative 3-sigma clipping about the
    median (sample standard deviation)."""
    v = (wave[1:] - wave[:-1]) / wave[1:] * CLIGHT_KMS
    keep = np.ones(v.shape, bool)
    for _ in range(maxiters):
        cur = v[keep]
        med = np.median(cur)
        std = np.std(cur, ddof=1) if cur.size > 1 else 0.0
        new = np.abs(v - med) <= sigma * std
        if not new.any() or np.array_equal(new, keep):
            break
        keep = new
    return float(np.median(v[keep]))


class Problem:
    """One fit problem, built from its ``.cfg`` and spectrum directory."""

    def __init__(self, cfg_path: str, datadir: str):
        cp = configparser.ConfigParser()
        if not cp.read(cfg_path):
            raise FileNotFoundError(cfg_path)

        def get(sec, key, default=None):
            return cp.get(sec, key) if cp.has_option(sec, key) else default

        if get("components", "gpriors") is not None:
            raise NotImplementedError("the reference has no Gaussian priors")
        self.asymm = str(get("input", "asymmlike", "False")).strip().lower() in (
            "true", "1", "yes", "on")
        specres = _floats(get("input", "specres", "7.0"))
        contval = _floats(get("components", "contval", "1.0"))
        # a range is a sampled slot of its own, before the ncomp slot
        self.free_res, self.free_cont = specres.size > 1, contval.size > 1
        self.startind = int(self.free_res) + int(self.free_cont)
        # the FWHM that sizes the LSF: a free resolution's upper end
        self.fwhm = float(specres[1]) if self.free_res else float(specres.max())
        self.cont = float(contval[0])

        toks = [float(x) for x in get("input", "wavefit").split(",")]
        fitrange = [(toks[2 * i], toks[2 * i + 1]) for i in range(len(toks) // 2)]
        coldef = [c.strip() for c in get("input", "coldef", "Wave, Flux, Err").split(",")]
        spec = str(Path(datadir) / get("input", "specfile").strip())
        wave, flux, noise = read_spectrum(spec, coldef)
        keep = np.zeros(wave.shape, bool)
        for lo, hi in fitrange:
            keep |= (wave > lo) & (wave < hi)
        self.wave, self.flux, self.noise = wave[keep], flux[keep], noise[keep]
        self.npix = self.wave.size
        self.velstep = velocity_step(self.wave)
        self.valid = np.isfinite(self.flux) & np.isfinite(self.noise) & (self.noise > 0)
        self.ivar = np.where(self.valid, 1.0 / np.where(self.valid, self.noise, 1.0) ** 2, 0.0)
        self.const_term = float(np.sum(-np.log(self.ivar[self.valid]) + math.log(2 * math.pi)))
        # asymmlike: the most valid pixels above 5 and above 4 noise widths
        self.asymm_limits = tuple(self.npix * float(ndtr(-k)) + 0.01 * self.npix
                                  for k in (5.0, 4.0))

        names = [x.strip() for x in get("input", "linelist").split(",")]
        lines = [_LINES[" ".join(n.split())] for n in names]
        ncomp = [int(x) for x in get("components", "ncomp", "1,1").split(",")]
        self.ncompmin, self.ncompmax = ncomp[0], ncomp[-1]
        self.nfill = int(get("components", "nfill", "0"))
        Nr = _pair(_floats(get("components", "Nrange", "11.5,16.0")))
        br = _pair(_floats(get("components", "brange", "1.0,30.0")))
        Nf = _pair(_floats(get("components", "Nrangefill", "11.5,16.0")))
        bf = _pair(_floats(get("components", "brangefill", "1.0,30.0")))
        zr = get("components", "zrange")
        w0 = lines[0]["wrest"]
        zlims = []
        for c in range(self.ncompmax):
            if zr is None:
                zlims.append(((fitrange[0][0] + 0.25) / w0 - 1, (fitrange[0][1] - 0.25) / w0 - 1))
            else:
                z = _floats(zr)
                zlims.append((z[0], z[1]) if z.size == 2 else (z[2 * c], z[2 * c + 1]))
        wr = get("components", "wrangefill")
        fill_lims = []
        for j in range(self.nfill):
            if wr is None:
                fill_lims.append(((self.wave.min() + 0.25) / FILLER_WREST - 1,
                                  (self.wave.max() - 0.25) / FILLER_WREST - 1))
            else:
                w = _floats(wr)
                lo, hi = (w[0], w[1]) if w.size == 2 else (w[2 * j], w[2 * j + 1])
                fill_lims.append((lo / FILLER_WREST - 1, hi / FILLER_WREST - 1))
        bounds = [(float(specres[0]), float(specres[1]))] if self.free_res else []
        if self.free_cont:
            bounds.append((float(contval[0]), float(contval[1])))
        bounds.append((float(self.ncompmin), float(self.ncompmax)))
        for c in range(self.ncompmax):
            bounds += [Nr, zlims[c], br]
        for j in range(self.nfill):
            bounds += [Nf, fill_lims[j], bf]
        self.lo = np.array([b[0] for b in bounds], np.float64)
        self.hi = np.array([b[1] for b in bounds], np.float64)
        self.ndim = self.lo.size

        # one row per transition: its parameter triplet's index, atomic data,
        # and which component it belongs to (fillers: always active)
        first = self.startind + 1
        trans = []
        for c in range(self.ncompmax):
            trans += [(first + 3 * c, ln, c, False) for ln in lines]
        filler = dict(lines[0], wrest=FILLER_WREST)
        for j in range(self.nfill):
            trans.append((first + 3 * self.ncompmax + 3 * j, filler, self.ncompmax + j, True))
        self.pidx = np.array([t[0] for t in trans])
        self.wrest = np.array([t[1]["wrest"] for t in trans], np.float64)
        self.fosc = np.array([t[1]["f"] for t in trans], np.float64)
        self.gamma = np.array([t[1]["gamma"] for t in trans], np.float64)
        self.comp = np.array([t[2] for t in trans])
        self.is_fill = np.array([t[3] for t in trans])
        self.ntrans = len(trans)

        sigma = self.fwhm / FWHM_TO_SIGMA / self.velstep
        self.half = int(math.ceil(SUPPORT_SIGMAS * sigma)) if self.fwhm > 0 else 0
        # (K,) taps of a fixed resolution; a free one makes each row's
        self.taps = None if self.free_res else self.lsf_taps(np.array([self.fwhm]))[0]
        self.cw = CCGS / (self.wave / 1e8)                  # c / lambda, Hz

    # ------------------------------------------------------------------
    def lsf_taps(self, fwhm: np.ndarray) -> np.ndarray:
        """(rows, K) normalised Gaussian taps at k = -half .. half pixels of
        the FWHMs ``fwhm`` (rows,), km/s."""
        sigma = np.asarray(fwhm, np.float64)[:, None] / FWHM_TO_SIGMA / self.velstep
        if not self.half:
            return np.ones((sigma.shape[0], 1))
        k = np.arange(-self.half, self.half + 1, dtype=np.float64)
        taps = np.exp(-(k ** 2) / (2.0 * sigma ** 2))
        return taps / taps.sum(axis=-1, keepdims=True)

    # ------------------------------------------------------------------
    def params(self, u: np.ndarray) -> np.ndarray:
        """Physical parameters (rows, ndim), float64."""
        return self.lo + np.asarray(u, np.float64) * (self.hi - self.lo)

    def ncomp_active(self, u: np.ndarray) -> np.ndarray:
        """floor of the ncomp slot as the float32 transform gives it."""
        i = self.startind
        u0 = np.asarray(u, np.float32)[:, i]
        lo, hi = np.float32(self.lo[i]), np.float32(self.hi[i])
        return np.floor(lo + u0 * (hi - lo)).astype(np.int64)

    def line_tables(self, u: np.ndarray):
        """Per (row, transition): z, amplitude TAU_CONST 10^N f / dnu (0 for
        an inactive component), damping a and Doppler width dnu."""
        p = self.params(u)
        active = (self.comp[None, :] < self.ncomp_active(u)[:, None]) | self.is_fill[None, :]
        N, z, b = p[:, self.pidx], p[:, self.pidx + 1], p[:, self.pidx + 2]
        dnu = b * 1e5 / (self.wrest * 1e-8)
        a = self.gamma / (4.0 * math.pi * dnu)
        amp = np.where(active, TAU_CONST * 10.0 ** N * self.fosc / dnu, 0.0)
        return z, amp, a, dnu, active

    def u_voigt(self, z: np.ndarray, dnu: np.ndarray) -> np.ndarray:
        """(rows, T, P) distance from line centre in Doppler widths."""
        nu0 = CCGS / (self.wrest * 1e-8)
        return ((1.0 + z)[..., None] * self.cw - nu0[:, None]) / dnu[..., None]

    def tau(self, u: np.ndarray) -> np.ndarray:
        z, amp, a, dnu, _ = self.line_tables(u)
        x = self.u_voigt(z, dnu)
        h = wofz(x + 1j * a[..., None]).real
        return np.einsum("rt,rtp->rp", amp, h)

    def convolve(self, flux: np.ndarray, taps: np.ndarray, tf32: bool = False) -> np.ndarray:
        """The LSF of ``taps`` ((K,), or (rows, K): each row its own),
        zero-padded, edge pixels unconvolved.  ``tf32``: the product of TF32
        operands (10 explicit mantissa bits) accumulated in float32, as a
        tensor-core convolution computes it."""
        h = self.half
        if h == 0:
            return flux
        P = flux.shape[-1]
        taps = np.atleast_2d(taps)
        if tf32:
            flux32, taps = to_tf32(flux), to_tf32(taps)
            pad = np.pad(flux32, ((0, 0), (h, h)))
            acc = np.zeros_like(flux32, dtype=np.float32)
            for k in range(2 * h + 1):
                acc = (acc + taps[:, k, None] * pad[:, k:k + P]).astype(np.float32)
            acc = acc.astype(np.float64)
        else:
            pad = np.pad(flux, ((0, 0), (h, h)))
            acc = np.zeros_like(flux)
            for k in range(2 * h + 1):
                acc += taps[:, k, None] * pad[:, k:k + P]
        edge = np.zeros(P, bool)
        edge[:h] = edge[P - h:] = True
        return np.where(edge, flux, acc)

    def loglike(self, u: np.ndarray, tf32: bool = False, block: int = 32) -> np.ndarray:
        """log L of unit-cube rows (rows, ndim), in blocks of ``block`` rows;
        -inf where ``asymmlike`` rejects the row's model."""
        u = np.atleast_2d(np.asarray(u))
        out = np.empty(u.shape[0], np.float64)
        for s in range(0, u.shape[0], block):
            ub = u[s:s + block]
            p = self.params(ub)
            taps = self.lsf_taps(p[:, 0]) if self.free_res else self.taps
            cont = p[:, int(self.free_res), None] if self.free_cont else self.cont
            model = cont * self.convolve(np.exp(-self.tau(ub)), taps, tf32)
            r = self.flux - model
            chi2 = np.sum(np.where(self.valid, self.ivar * r * r, 0.0), axis=-1)
            out[s:s + block] = -0.5 * (chi2 + self.const_term)
            if self.asymm:
                z = np.where(self.valid, r / np.where(self.valid, self.noise, 1.0), 0.0)
                n5, n4 = np.sum(z > 5.0, axis=-1), np.sum(z > 4.0, axis=-1)
                lim5, lim4 = self.asymm_limits
                out[s:s + block] = np.where((n5 > lim5) | (n4 > lim4), -np.inf, out[s:s + block])
        return out


def to_tf32(x) -> np.ndarray:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest
    even."""
    return _round_mantissa(x, 13)


def to_bf16(x) -> np.ndarray:
    """Round to bfloat16 (7 explicit mantissa bits), to nearest even, as
    float32."""
    return _round_mantissa(x, 16)


def _round_mantissa(x, drop: int) -> np.ndarray:
    a = np.array(x, dtype=np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    half = (1 << (drop - 1)) - 1
    bits = (bits + half + ((bits >> drop) & 1)) & ~np.uint64((1 << drop) - 1)
    out = bits.astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), out, a)

