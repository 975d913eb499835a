// Fused Voigt likelihood for Hopper (sm_90a): tau -> exp(-tau) -> LSF
// convolution ('same_edge') -> continuum -> chi^2 (+ asymmetric-likelihood
// outlier counts), one CTA per sample, nothing through device memory but the
// three (B,) outputs.
//
// Replaces the two fused Pallas TPU kernels of mcalf_tpu/ops/voigt_pallas.py,
// _ll_kernel and _ll_kernel_win.  The TPU needed a window table because its
// vector unit evaluates both sides of a select; here a per-pixel branch skips
// the work a pixel does not need by itself, so ONE kernel computes every
// transition's H in its mode (voigt_h.cuh): plain Harris (mode 0), the
// hjert_harris_win selection (mode 1: u^2 < tmin takes the full Harris
// expansion, the rest the 7-term wing polynomial), or full hjert (mode 2:
// Algorithm 916 where u^2 + a^2 < 111, the asymptotic form elsewhere).  That
// is exactly _ll_kernel's value, and _ll_kernel_win's to within its own
// amp_max * e^{-tmin} < 1e-8 tau bound.
//
// What bounds it on an H100: the special functions.  Per (transition, pixel)
// pair the Harris path costs about 100 operations and the 916 series about
// 250 (an expf, a sinf, a cosf, two more expf and 81 multiply-adds), against
// about 8 bytes x P of device-memory traffic per sample (the L2-resident d0
// table aside), so it is compute-bound, not memory-bound.  The design answers
// that with the per-pixel branches (wing pixels skip the exponential and the
// Dawson regions, far pixels of a damped line take the few-operation
// asymptotic form) and with the y-only 916 quantities computed once per
// (sample, transition) into shared memory.  One CTA per sample keeps exp(-tau)
// in shared memory for the convolution and reduces chi^2 in-block.

#include <cuda_runtime.h>

#include "voigt_h.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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
                     const float* __restrict__ tmin,    // (T,) mode-1 thresholds
                     const int* __restrict__ mode,      // (T,) 0, 1 or 2
                     float* __restrict__ chi2,          // (B,)
                     float* __restrict__ n4,            // (B,)
                     float* __restrict__ n5,            // (B,)
                     int T, int P, int half, int kern_stride, int cont_stride,
                     int asymm) {
  extern __shared__ float smem[];
  mcalf::LineTables L;
  float* s_kern = mcalf::carve_line_tables(smem, T, L);
  const int K = 2 * half + 1;
  float* s_flux = s_kern + K;  // (P,)

  __shared__ float r_chi[kWarps];
  __shared__ int r_n4[kWarps];
  __shared__ int r_n5[kWarps];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  // Per-(sample, transition) scalars, read uniformly by every thread (the
  // loader ends in a barrier, which also publishes the taps).
  for (int k = tid; k < K; k += kThreads) s_kern[k] = kern[b * kern_stride + k];
  mcalf::load_line_tables(L, b, T, dz, gain, av, dnu, tmin, mode);

  // tau synthesis + exp, one pixel per thread per step.
  if (L.any_damped) {
    for (int p = tid; p < P; p += kThreads)
      s_flux[p] = expf(-mcalf::tau_at<true>(L, T, P, d0, cw[p], p));
  } else {
    for (int p = tid; p < P; p += kThreads)
      s_flux[p] = expf(-mcalf::tau_at<false>(L, T, P, d0, cw[p], p));
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
    const float* tmin, const int* mode, float* chi2, float* n4, float* n5,
    int B, int T, int P, int half, int kern_stride, int cont_stride, int asymm,
    void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(mcalf::kLineWords) * T +
                       (2 * half + 1) + P);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_loglike_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_loglike_kernel<<<B, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin, mode,
      chi2, n4, n5, T, P, half, kern_stride, cont_stride, asymm);
  return static_cast<int>(cudaGetLastError());
}
