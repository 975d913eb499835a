// Voigt optical depth for Hopper (sm_90a): tau(B, P) = sum_t gain[b, t]
// H(u, a[b, t]), u = (d0[t, p] + dz[b, t] c[p]) / dnu[b, t], each transition's
// H in its mode (voigt_h.cuh: plain Harris, windowed Harris, or full hjert).
//
// Replaces the Pallas TPU kernel mcalf_tpu/ops/voigt_pallas.py::_tau_kernel
// (entry voigt_tau_pallas), which the JAX package runs for the model flux of
// JaxForward.reconstruct and .chi2 and for .loglike outside 'same_edge'.
// The TPU kernel pads B to 8-row and P to 512-lane tiles, with a damping of
// 1e6 in the padding rows to keep them in the cheap asymptotic branch; here
// each CTA masks the ragged pixel edge and the last sample group itself, and
// no padding row exists.
//
// What bounds it on an H100: the special functions, as in the fused kernel.
// The only device-memory traffic that scales with the work is the (B, P)
// float32 store, 0.8 MB at B = 100 and P = 1999 (about 0.24 us at
// 3.35 TB/s), against about 30-40 (Harris) to 250 (916 series) operations per
// (transition, pixel) pair: compute-bound, and each pixel's tau is a serial
// chain over the transitions (the order of the sum is fixed).  The design:
//   * Two instantiations, picked by the host from the mode table
//     (voigt_cuda._any_damped): Harris-only, whose registers allow
//     kHarrisMinCtas CTAs of kMaxThreads per SM, and damped, whose
//     non-inlined Algorithm-916 call needs more (kDampedMinCtas): its fully
//     unrolled form, wofz_real_916<false>, faster per call than the fused
//     kernel's register-lean one.
//   * Several samples per thread: a CTA takes one pixel tile (a pixel per
//     thread) of one group of S samples; a thread loads d0[t, p] once per
//     transition and updates S independent sums, S chains for the scheduler
//     and 1/S of the d0 reads and table loads.  S (up to 4, or 2 for the
//     damped kernel) is chosen per launch by voigt_cuda.tau_geometry: the
//     largest that still gives the card enough warps of work.  The sums of
//     a group of n samples are an unrolled loop of n, so the last group's
//     samples past B compute nothing and write nothing.
//   * One CTA per (sample group, pixel tile) work item, a one-dimensional
//     grid (no grid dimension limits B).  Dealing the items in runs to one
//     wave of CTAs, which fills each group's tables once per run, measured
//     slower in every cell on an H100: the card's own scheduling of many
//     short CTAs evens out the data-dependent cost of the tiles better.
//   * An optional problem axis (kProb, the fused kernel's pattern): given
//     prob (B,), sample b reads problem prob[b]'s d0 (Q, T, P) rows and
//     c/lambda (Q, P) row, so one launch serves the stacked problems of a
//     fleet whatever order their rows come in.  The groups stay groups of S
//     consecutive rows, which may span problems: each sample of a group
//     keeps its own d0 column and c, and loads them itself.
// Per element the order of operations is the previous one-sample kernel's
// (the same fused multiply-add for u, the Harris transitions then the damped
// ones, each in ascending t), so tau is bit for bit the same, and a stacked
// row is bit for bit its problem's single-problem launch.

#include <cuda_runtime.h>

#include "voigt_h.cuh"

namespace {

using mcalf::kTerms;

constexpr int kMaxThreads = 256;  // threads per CTA at most
// Samples per group (S) at most: four sums in flight for the Harris-only
// kernel; two for the damped one, whose sums live across the 916 call
// (with four, 80 registers no longer hold them without spilling).
constexpr int kHarrisMaxSamples = 4;
constexpr int kDampedMaxSamples = 2;
// Resident CTAs of kMaxThreads per SM the registers must allow: 64
// registers for the Harris-only kernel, 80 for the damped one (the 916 call).
constexpr int kHarrisMinCtas = 4;
constexpr int kDampedMinCtas = 3;

template <bool kDamped>
constexpr int max_samples() {
  return kDamped ? kDampedMaxSamples : kHarrisMaxSamples;
}

// Shared memory of a group's tables: per (transition t, sample s), record
// r = t S + s, the two 16-byte LineTables words rec[2r], rec[2r + 1], and
// the kTerms series denominators den[r kTerms ...] (mode 2 only).
size_t group_smem(int T, int S) {
  return sizeof(float) * static_cast<size_t>(mcalf::kLineWords) * S * T;
}

// Fills the tables of samples b0 .. b0 + n - 1 of a group of S (the records
// of the group's other samples are never read); every thread of the CTA
// takes part, and all of them see the filled tables on return.  A mode-0
// transition gets the threshold +inf, as in mcalf::load_line_tables, whose
// arithmetic this repeats per sample.
template <bool kDamped>
__device__ __forceinline__ void load_group(
    float4* rec, float* den, int S, int b0, int n, int T,
    const float* __restrict__ dz, const float* __restrict__ gain,
    const float* __restrict__ av, const float* __restrict__ dnu,
    const float* __restrict__ tmin, const int* __restrict__ mode) {
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  int harris = 0;
  for (int r = tid; r < S * T; r += nth) {
    const int t = r / S;
    const int s = r - t * S;
    const int m = mode[t];
    harris |= m != 2;
    if (s >= n) continue;
    const int i = (b0 + s) * T + t;
    rec[2 * r] = make_float4(dz[i], 1.0f / dnu[i], gain[i], av[i]);
    rec[2 * r + 1] = make_float4(m == 0 ? __int_as_float(0x7f800000) : tmin[t],
                                 0.0f, 0.0f, __int_as_float(m));
  }
  if (!kDamped) {
    __syncthreads();
    return;
  }
  // the host's choice says some transition is in mode 2; whether one is in
  // mode 0 or 1 decides if the Harris loop runs (published by the barriers)
  const int h = __syncthreads_or(harris);
  if (tid == 0) mcalf::any_harris = h;
  for (int i = tid; i < S * T * kTerms; i += nth) {
    const int r = i / kTerms;
    if (r % S < n && __float_as_int(rec[2 * r + 1].w) == 2) {
      const float a = rec[2 * r].w;
      den[i] = 1.0f / (mcalf::kAn2[i - r * kTerms] + a * a);
    }
  }
  __syncthreads();
  for (int r = tid; r < S * T; r += nth) {
    if (r % S < n && __float_as_int(rec[2 * r + 1].w) == 2) {
      float s = 0.0f;
      for (int k = 0; k < kTerms; ++k) s = s + mcalf::kExpAn2[k] * den[r * kTerms + k];
      rec[2 * r + 1].z = s;
      rec[2 * r + 1].y = mcalf::erfcx(rec[2 * r].w);
    }
  }
  __syncthreads();
}

// tau at one pixel of the first N samples of a group of S, written to
// out[s P]: the per-sample arithmetic of mcalf::tau_at, N sums in flight.
// d0col[j] points at the pixel's d0[0, p] (rows P floats apart) and c[j] is
// c/lambda there, for j < kCols: one column shared by the group (kCols = 1),
// or with the problem axis one per sample (kCols = N, sample s's is j = s).
// Neighbouring threads take neighbouring pixels, so the reads are coalesced
// and the table stays resident in L2.
template <bool kDamped, bool kProb, int N>
__device__ __forceinline__ void group_tau(const float4* rec, const float* den,
                                          int S, int T, int P,
                                          const float* const* d0col,
                                          const float* c, float* __restrict__ out) {
  constexpr int kCols = kProb ? N : 1;
  float tau[N];
#pragma unroll
  for (int s = 0; s < N; ++s) tau[s] = 0.0f;
  // Each transition's d0 is loaded one transition ahead, so its L2 latency
  // overlaps the previous transition's H.
  const float* d0p[kCols];
  float dnext[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    d0p[j] = d0col[j];
    dnext[j] = T > 0 ? *d0p[j] : 0.0f;
  }
  const int nh = (kDamped && !mcalf::any_harris) ? 0 : T;  // skip an idle loop
  for (int t = 0; t < nh; ++t) {
    float d[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      d[j] = dnext[j];
      d0p[j] += P;
      if (t + 1 < T) dnext[j] = *d0p[j];
    }
    const float4* r = rec + 2 * S * t;
    if (kDamped && __float_as_int(r[1].w) == 2) continue;  // mode: same for all s
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int j = kProb ? s : 0;
      const float4 q = r[2 * s];          // dz, 1/dnu, gain, a
      const float thr = r[2 * s + 1].x;   // tmin, +inf in mode 0
      const float u = (d[j] + q.x * c[j]) * q.y;
      const float u2 = u * u;
      const float H = !(u2 < thr) ? mcalf::hjert_wing(u2, q.w)
                                  : mcalf::hjert_harris(u2, q.w);
      tau[s] = tau[s] + q.z * H;
    }
  }
  if (kDamped) {
    for (int t = 0; t < T; ++t) {
      const float4* r = rec + 2 * S * t;
      if (__float_as_int(r[1].w) != 2) continue;
      float d[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) d[j] = d0col[j][static_cast<size_t>(t) * P];
#pragma unroll
      for (int s = 0; s < N; ++s) {
        const int j = kProb ? s : 0;
        const float4 q = r[2 * s];
        const float4 w = r[2 * s + 1];  // tmin, erfcx(a), sigma1, mode
        const float u = (d[j] + q.x * c[j]) * q.y;
        const float a = q.w;
        const float H =
            (u * u + a * a < MCALF_R2_SWITCH)
                ? mcalf::wofz_real_916<false>(fabsf(u), a, w.y, w.z, den + (S * t + s) * kTerms)
                : mcalf::wofz_real_asym(u, a);
        tau[s] = tau[s] + q.z * H;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < N; ++s) out[static_cast<size_t>(s) * P] = tau[s];
}

// CTA i takes pixel tile i % ntiles (blockDim.x pixels, one per thread) of
// sample group i / ntiles, samples [g S, min(g S + S, B)).  With the problem
// axis (kProb) sample b's tables are problem prob[b]'s.
template <bool kDamped, bool kProb>
__global__ void __launch_bounds__(kMaxThreads, kDamped ? kDampedMinCtas : kHarrisMinCtas)
voigt_tau_kernel(const float* __restrict__ dz,    // (B, T)
                 const float* __restrict__ gain,  // (B, T)
                 const float* __restrict__ av,    // (B, T)
                 const float* __restrict__ dnu,   // (B, T)
                 const float* __restrict__ d0,    // (T, P), or (Q, T, P) with prob
                 const float* __restrict__ cw,    // (P,), or (Q, P) with prob
                 const float* __restrict__ tmin,  // (T,) mode-1 thresholds
                 const int* __restrict__ mode,    // (T,) 0, 1 or 2
                 const int* __restrict__ prob,    // (B,) problem per sample, or null
                 float* __restrict__ tau,         // (B, P)
                 int B, int T, int P, int S, int ntiles) {
  extern __shared__ float4 smem_raw[];  // 16-byte aligned records
  float4* rec = smem_raw;
  float* den = reinterpret_cast<float*>(rec + 2 * S * T);
  const int g = blockIdx.x / ntiles;
  const int b0 = g * S;
  const int n = min(S, B - b0);
  load_group<kDamped>(rec, den, S, b0, n, T, dz, gain, av, dnu, tmin, mode);
  const int p = (blockIdx.x - g * ntiles) * blockDim.x + threadIdx.x;
  if (p >= P) return;
  constexpr int kMax = kDamped ? kDampedMaxSamples : kHarrisMaxSamples;
  constexpr int kCols = kProb ? kMax : 1;
  const float* col[kCols];
  float c[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    // a sample past the group's n takes the group's first problem: its
    // column is read ahead but never used
    const size_t q = kProb ? static_cast<size_t>(prob[b0 + (j < n ? j : 0)]) : 0;
    col[j] = d0 + q * T * P + p;
    c[j] = cw[q * P + p];
  }
  float* out = tau + static_cast<size_t>(b0) * P + p;
  // n is uniform across the CTA
  if constexpr (kDamped) {
    static_assert(kDampedMaxSamples == 2, "the damped kernel takes 1 or 2 samples");
    if (n == 2) group_tau<true, kProb, 2>(rec, den, S, T, P, col, c, out);
    else group_tau<true, kProb, 1>(rec, den, S, T, P, col, c, out);
  } else {
    static_assert(kHarrisMaxSamples == 4, "the Harris-only kernel takes 1 to 4 samples");
    switch (n) {
      case 4: group_tau<false, kProb, 4>(rec, den, S, T, P, col, c, out); break;
      case 3: group_tau<false, kProb, 3>(rec, den, S, T, P, col, c, out); break;
      case 2: group_tau<false, kProb, 2>(rec, den, S, T, P, col, c, out); break;
      default: group_tau<false, kProb, 1>(rec, den, S, T, P, col, c, out); break;
    }
  }
}

// The geometry voigt_cuda.tau_geometry gave, checked against what the kernel
// indexes, so a wrong one is refused instead of reading out of bounds.
template <bool kDamped>
bool geometry_ok(int B, int T, int P, int S, int threads, int ntiles, int grid,
                 int smem) {
  return B >= 1 && T >= 0 && P >= 1 && S >= 1 && S <= max_samples<kDamped>() &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         ntiles == (P + threads - 1) / threads &&
         grid == static_cast<long long>((B + S - 1) / S) * ntiles && smem >= 0 &&
         static_cast<size_t>(smem) >= group_smem(T, S);
}

template <bool kDamped, bool kProb>
cudaError_t allow_smem(int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(voigt_tau_kernel<kDamped, kProb>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool kDamped, bool kProb>
cudaError_t launch(const float* dz, const float* gain, const float* av,
                   const float* dnu, const float* d0, const float* cw,
                   const float* tmin, const int* mode, const int* prob, float* tau,
                   int B, int T, int P, int S, int threads, int ntiles, int grid,
                   int smem, void* stream) {
  if (!geometry_ok<kDamped>(B, T, P, S, threads, ntiles, grid, smem))
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<kDamped, kProb>(smem);
  if (e != cudaSuccess) return e;
  voigt_tau_kernel<kDamped, kProb>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          dz, gain, av, dnu, d0, cw, tmin, mode, prob, tau, B, T, P, S, ntiles);
  return cudaGetLastError();
}

template <bool kDamped>
cudaError_t occupancy(int threads, int smem, int* ctas_per_sm) {
  const cudaError_t e = allow_smem<kDamped, false>(smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, voigt_tau_kernel<kDamped, false>, threads, static_cast<size_t>(smem));
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising.
// `damped`: some transition is in mode 2 (the host knows it from the mode
// table, voigt_cuda._any_damped); `prob`: null, or the (B,) problem of each
// sample, d0 then (Q, T, P) and cw (Q, P) (every entry must lie in [0, Q):
// the kernel does not check it); `samples` (S), `threads`, `ntiles`, `grid`
// and `smem` are voigt_cuda.tau_geometry's.  Returns the first CUDA error: a
// refused launch never runs, and only this check reports it.
extern "C" int mcalf_voigt_tau_groups(const float* dz, const float* gain,
                                      const float* av, const float* dnu,
                                      const float* d0, const float* cw,
                                      const float* tmin, const int* mode,
                                      const int* prob, float* tau, int B, int T,
                                      int P, int damped, int samples, int threads,
                                      int ntiles, int grid, int smem, void* stream) {
  const auto go = damped ? (prob ? launch<true, true> : launch<true, false>)
                         : (prob ? launch<false, true> : launch<false, false>);
  return static_cast<int>(go(dz, gain, av, dnu, d0, cw, tmin, mode, prob, tau, B, T,
                             P, samples, threads, ntiles, grid, smem, stream));
}

// The version of mcalf_voigt_tau_groups' argument list: 2 since it takes the
// problem axis `prob` (a library without this symbol has the older list).
extern "C" int mcalf_voigt_tau_abi() { return 2; }

// CTAs of `threads` threads with `smem` bytes of dynamic shared memory of the
// instantiation for `damped` (without the problem axis) resident on one SM.
extern "C" int mcalf_voigt_tau_occupancy(int damped, int threads, int smem,
                                         int* ctas_per_sm) {
  return static_cast<int>(
      (damped ? occupancy<true> : occupancy<false>)(threads, smem, ctas_per_sm));
}
