// Fused Voigt likelihood for Hopper (sm_90a): tau -> exp(-tau) -> LSF
// convolution ('same_edge') -> continuum -> chi^2 (+ asymmetric-likelihood
// outlier counts), one CTA per sample, nothing through device memory but the
// three (B,) outputs.
//
// Replaces the two fused Pallas TPU kernels of mcalf_tpu/ops/voigt_pallas.py,
// _ll_kernel and _ll_kernel_win.  The TPU needed a window table because its
// vector unit evaluates both sides of a select; here a per-pixel branch skips
// the Harris work on wing pixels by itself, so ONE kernel computes the
// hjert_harris_win selection per pixel: for a windowed transition (tmin > 0)
// u^2 < tmin takes the full Harris expansion and the rest the 7-term wing
// polynomial; a plain-Harris transition (tmin == 0) takes the Harris
// expansion everywhere.  That is exactly _ll_kernel's value, and
// _ll_kernel_win's to within its own amp_max * e^{-tmin} < 1e-8 tau bound.
// Warps diverge only at the edges of each transition's Harris region, one
// contiguous pixel interval per sample because u is monotone in p.
//
// The Dawson coefficient tables come from mcalf_torch/ops/faddeeva.py through
// the generated header fused_loglike_coefs.h (mcalf_torch/ops/_build.py).
//
// Numerics: full-precision float32 (no --use_fast_math): expf and the
// divisions are the IEEE-accurate versions the accuracy bars rely on.

#include <cuda_runtime.h>

#include "fused_loglike_coefs.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__constant__ float kP1[] = MCALF_DAWSN_P1;
__constant__ float kP2[] = MCALF_DAWSN_P2;
__constant__ float kP3[] = MCALF_DAWSN_P3;
__constant__ float kP4[] = MCALF_DAWSN_P4;

template <int N>
__device__ __forceinline__ float horner(const float (&c)[N], float x) {
  float p = c[N - 1];
#pragma unroll
  for (int i = N - 2; i >= 0; --i) p = p * x + c[i];
  return p;
}

// hjert_harris(u, a) with t = u^2: e^{-t}(1 + a^2(1 - 2t)) + a (2/sqrt(pi))
// (2uF(u) - 1), the Dawson core evaluated in the one region t selects.
__device__ __forceinline__ float hjert_harris(float t, float a) {
  const float E = expf(-t);
  float h1core;
  if (t <= 6.25f) {
    const float ph = (t <= 2.25f) ? horner(kP1, t) : horner(kP2, t - 4.25f);
    h1core = 2.0f * t * ph - 1.0f;
  } else {
    const float v = 1.0f / t;
    const float g = (t <= 16.0f) ? horner(kP3, v - 0.111f) : horner(kP4, v);
    h1core = v * g;
  }
  return E * (1.0f + a * a * (1.0f - 2.0f * t)) +
         a * (MCALF_TWO_OVER_SQRTPI * h1core);
}

// hjert_wing(u, a): the Harris tail without its e^{-t} terms.
__device__ __forceinline__ float hjert_wing(float t, float a) {
  const float v = 1.0f / fmaxf(t, 16.0f);
  return a * ((MCALF_TWO_OVER_SQRTPI * v) * horner(kP4, v));
}

__global__ void __launch_bounds__(kThreads)
fused_loglike_kernel(const float* __restrict__ dz,      // (B, T)
                     const float* __restrict__ gain,    // (B, T)
                     const float* __restrict__ av,      // (B, T)
                     const float* __restrict__ dnu,     // (B, T)
                     const float* __restrict__ d0,      // (T, P)
                     const float* __restrict__ cw,      // (P,)
                     const float* __restrict__ data,    // (P,)
                     const float* __restrict__ ivar,    // (P,)
                     const float* __restrict__ inv_noise,  // (P,)
                     const float* __restrict__ kern,    // (B or 1, K)
                     const float* __restrict__ cont,    // (B or 1,)
                     const float* __restrict__ tmin,    // (T,) 0 = plain Harris
                     float* __restrict__ chi2,          // (B,)
                     float* __restrict__ n4,            // (B,)
                     float* __restrict__ n5,            // (B,)
                     int T, int P, int half, int kern_stride, int cont_stride,
                     int asymm) {
  extern __shared__ float smem[];
  float* s_dz = smem;
  float* s_gain = s_dz + T;
  float* s_av = s_gain + T;
  float* s_idnu = s_av + T;
  float* s_tmin = s_idnu + T;
  const int K = 2 * half + 1;
  float* s_kern = s_tmin + T;
  float* s_flux = s_kern + K;  // (P,)

  __shared__ float r_chi[kWarps];
  __shared__ int r_n4[kWarps];
  __shared__ int r_n5[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // Per-(sample, transition) scalars, read uniformly by every thread.
  for (int t = tid; t < T; t += kThreads) {
    s_dz[t] = dz[b * T + t];
    s_gain[t] = gain[b * T + t];
    s_av[t] = av[b * T + t];
    s_idnu[t] = 1.0f / dnu[b * T + t];
    s_tmin[t] = tmin[t];
  }
  for (int k = tid; k < K; k += kThreads) s_kern[k] = kern[b * kern_stride + k];
  __syncthreads();

  // tau synthesis + exp, one pixel per thread per step; d0 rows are read
  // coalesced and stay resident in L2 across CTAs.
  for (int p = tid; p < P; p += kThreads) {
    const float c = cw[p];
    float tau = 0.0f;
    for (int t = 0; t < T; ++t) {
      const float u = (d0[t * P + p] + s_dz[t] * c) * s_idnu[t];
      const float u2 = u * u;
      const float tm = s_tmin[t];
      const float H = (tm > 0.0f && !(u2 < tm)) ? hjert_wing(u2, s_av[t])
                                                : hjert_harris(u2, s_av[t]);
      tau = tau + s_gain[t] * H;
    }
    s_flux[p] = expf(-tau);
  }
  __syncthreads();

  // LSF convolution ('same_edge': the half edge pixels keep the unconvolved
  // flux, so every interior tap lies inside [0, P)), continuum, residuals.
  const float cb = cont[b * cont_stride];
  float chi = 0.0f;
  int c4 = 0, c5 = 0;
  for (int p = tid; p < P; p += kThreads) {
    float m = s_flux[p];
    if (half > 0 && p >= half && p < P - half) {
      const float* row = s_flux + (p - half);
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc = acc + s_kern[k] * row[k];
      m = acc;
    }
    m = m * cb;
    const float r = data[p] - m;
    chi = chi + ivar[p] * r * r;
    if (asymm) {
      const float rn = r * inv_noise[p];
      c4 += rn > 4.0f;
      c5 += rn > 5.0f;
    }
  }

  // Block reduction: warp shuffles, then one warp over the warp partials.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    chi += __shfl_down_sync(0xffffffffu, chi, off);
    c4 += __shfl_down_sync(0xffffffffu, c4, off);
    c5 += __shfl_down_sync(0xffffffffu, c5, off);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    r_chi[warp] = chi;
    r_n4[warp] = c4;
    r_n5[warp] = c5;
  }
  __syncthreads();
  if (warp == 0) {
    chi = lane < kWarps ? r_chi[lane] : 0.0f;
    c4 = lane < kWarps ? r_n4[lane] : 0;
    c5 = lane < kWarps ? r_n5[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      chi += __shfl_down_sync(0xffffffffu, chi, off);
      c4 += __shfl_down_sync(0xffffffffu, c4, off);
      c5 += __shfl_down_sync(0xffffffffu, c5, off);
    }
    if (lane == 0) {
      chi2[b] = chi;
      n4[b] = static_cast<float>(c4);
      n5[b] = static_cast<float>(c5);
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError(): a refused launch (too much shared memory, bad
// configuration) never runs, and only this check reports it.
extern "C" int mcalf_fused_loglike(
    const float* dz, const float* gain, const float* av, const float* dnu,
    const float* d0, const float* cw, const float* data, const float* ivar,
    const float* inv_noise, const float* kern, const float* cont,
    const float* tmin, float* chi2, float* n4, float* n5, int B, int T, int P,
    int half, int kern_stride, int cont_stride, int asymm, void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(5) * T + (2 * half + 1) + P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_loglike_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_loglike_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, chi2,
      n4, n5, T, P, half, kern_stride, cont_stride, asymm);
  return static_cast<int>(cudaGetLastError());
}
