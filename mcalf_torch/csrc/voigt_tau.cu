// Voigt optical depth for Hopper (sm_90a): tau(B, P) = sum_t gain[b, t]
// H(u, a[b, t]), u = (d0[t, p] + dz[b, t] c[p]) / dnu[b, t], each transition's
// H in its mode (voigt_h.cuh: plain Harris, windowed Harris, or full hjert).
//
// Replaces the Pallas TPU kernel mcalf_tpu/ops/voigt_pallas.py::_tau_kernel
// (entry voigt_tau_pallas), which the JAX package runs for the model flux of
// JaxForward.reconstruct and .chi2 and for .loglike outside 'same_edge'.
// The TPU kernel pads B to 8-row and P to 512-lane tiles, with a damping of
// 1e6 in the padding rows to keep them in the cheap asymptotic branch; here
// each CTA masks the ragged pixel edge itself and no padding row exists.
//
// What bounds it on an H100: the special functions, as in the fused kernel.
// The only device-memory traffic that scales with the work is the (B, P)
// float32 store, 0.8 MB at B = 100 and P = 1999 (about 0.24 us at
// 3.35 TB/s), against about 100 (Harris) to 250 (916 series) operations per
// (transition, pixel) pair: compute-bound.  The design: one thread per output
// pixel, a CTA per (sample, 256-pixel tile), the per-(sample, transition)
// scalars, modes and 916 y-only quantities in shared memory (computed once
// per CTA), d0 rows read coalesced from L2, and a coalesced store.

#include <cuda_runtime.h>

#include "voigt_h.cuh"

namespace {

constexpr int kThreads = 256;
// gridDim.y limit; larger batches loop over samples inside the CTA
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
voigt_tau_kernel(const float* __restrict__ dz,    // (B, T)
                 const float* __restrict__ gain,  // (B, T)
                 const float* __restrict__ av,    // (B, T)
                 const float* __restrict__ dnu,   // (B, T)
                 const float* __restrict__ d0,    // (T, P)
                 const float* __restrict__ cw,    // (P,)
                 const float* __restrict__ tmin,  // (T,) mode-1 thresholds
                 const int* __restrict__ mode,    // (T,) 0, 1 or 2
                 float* __restrict__ tau,         // (B, P)
                 int B, int T, int P) {
  extern __shared__ float4 smem_raw[];  // 16-byte aligned line records
  float* smem = reinterpret_cast<float*>(smem_raw);
  mcalf::LineTables L;
  mcalf::carve_line_tables(smem, T, L);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const float c = p < P ? cw[p] : 0.0f;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    mcalf::load_line_tables(L, b, T, dz, gain, av, dnu, tmin, mode);
    if (p < P) {
      tau[static_cast<size_t>(b) * P + p] =
          L.any_damped ? mcalf::tau_at<true>(L, T, d0 + p, P, c)
                       : mcalf::tau_at<false>(L, T, d0 + p, P, c);
    }
    __syncthreads();  // the next sample's tables overwrite these
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising.
// Returns cudaGetLastError(): a refused launch never runs, and only this check
// reports it.
extern "C" int mcalf_voigt_tau(const float* dz, const float* gain,
                               const float* av, const float* dnu,
                               const float* d0, const float* cw,
                               const float* tmin, const int* mode, float* tau,
                               int B, int T, int P, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(mcalf::kLineWords) * T;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        voigt_tau_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((P + kThreads - 1) / kThreads, B < kMaxGridY ? B : kMaxGridY);
  voigt_tau_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      dz, gain, av, dnu, d0, cw, tmin, mode, tau, B, T, P);
  return static_cast<int>(cudaGetLastError());
}
