// Fused Voigt likelihood for Hopper (sm_90a): tau -> exp(-tau) -> LSF
// convolution ('same_edge') -> continuum -> chi^2 (+ asymmetric-likelihood
// outlier counts), each sample's spectrum split over one thread block
// cluster, nothing through device memory but the three (B,) outputs.
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
// pair the Harris path costs about 30-40 operations and the 916 series about
// 250 (an expf, a sinf, a cosf, two more expf and 81 multiply-adds), against
// about 8 bytes x P of device-memory traffic per sample (the L2-resident d0
// table aside), so it is compute-bound, not memory-bound.  Each pixel's tau
// is a serial chain over the transitions (the order of the sum is fixed), so
// the card is kept busy by many chains in flight, and each chain is kept
// short in instructions:
//   * Grid: B clusters of `cluster` CTAs (mcalf_torch/ops/voigt_cuda.py::
//     fused_geometry chooses it: one 256-pixel tile per CTA, at most 8 CTAs,
//     the portable cluster size).  CTA r of a cluster owns pixels
//     [r*tile, min((r+1)*tile, P)); at the flagship's P = 1999 and B = 100
//     that is 800 CTAs over the 132 SMs, one pixel per thread.
//   * Registers: two instantiations, chosen by the host from the mode table
//     (voigt_cuda._any_damped).  A model with only Harris transitions runs in
//     48 registers, 5 CTAs (40 warps) per SM; one with a strongly damped
//     transition needs 80 for the non-inlined 916 call, 3 CTAs (24 warps).
//   * Per (transition, pixel) step: the transition's scalars are one 32-byte
//     record in shared memory (voigt_h.cuh LineTables), d0 is walked by a
//     pointer and loaded one transition ahead, mode 0 is folded into the
//     mode-1 threshold, and the reciprocals skip a range check u^2 never
//     needs: about 45 instructions for a wing step, down from about 70.
//   * Halo: the LSF reads `half` pixels beyond each tile edge.  Every CTA
//     writes exp(-tau) of its own tile into shared memory, the cluster syncs,
//     and each CTA copies its neighbours' edge pixels through distributed
//     shared memory; no pixel's tau is computed twice.  The 'same_edge' rule
//     (the first and last `half` pixels keep the unconvolved flux) applies at
//     the spectrum's ends only.
//   * chi^2, n4, n5: each CTA reduces its tile (warp shuffles, then one warp
//     over the warp partials) and stores its partials into CTA 0's shared
//     memory; after the cluster's second and last barrier CTA 0 sums them in
//     rank order.  No float atomics: repeated launches on the same inputs
//     are bit-identical.
//   * Per pixel the model flux is the previous one-CTA-per-sample kernel's bit
//     for bit (the same fused multiply-add for u, the same transition order,
//     the same tap order, reciprocals equal to IEEE division on the range
//     used); only the order of the chi^2 sum changed.
//   * Problem axis (the fleet, mcalf_torch/parallel/fleet.py): with `prob`
//     set, d0 is (Q, T, P) and cw, data, ivar, inv_noise are (Q, P), and
//     sample b reads problem prob[b]'s rows of them; its line tables, taps
//     and continuum are per sample already.  A sample's cluster computes it
//     alone, so its result does not depend on the other rows of the batch:
//     a stacked row is the single-problem launch's row bit for bit.
// Shared memory holds the line tables, the taps and one tile plus its halo,
// so the spectrum's length no longer bounds it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "voigt_h.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size

// Offset of sample b's problem's row in a (Q, P) table; 0 without a problem
// axis.  An int (the wrapper keeps Q * T * P below 2^31), so a table's
// address stays its base in the constant bank plus one index register, as
// without the problem axis.
__device__ __forceinline__ int problem_row(const int* prob, int b, int P) {
  return prob == nullptr ? 0 : prob[b] * P;
}

// Resident CTAs per SM the registers must allow: 5 x 8 = 40 warps for a
// model with only Harris transitions (48 registers), 3 x 8 = 24 for one with
// a strongly damped transition, whose non-inlined Algorithm-916 call needs
// up to 80 registers without spilling.
template <bool kDamped>
__global__ void __launch_bounds__(kThreads, kDamped ? 3 : 5)
fused_loglike_kernel(const float* __restrict__ dz,      // (B, T)
                     const float* __restrict__ gain,    // (B, T)
                     const float* __restrict__ av,      // (B, T)
                     const float* __restrict__ dnu,     // (B, T)
                     const float* __restrict__ d0,      // ([Q,] T, P)
                     const float* __restrict__ cw,      // ([Q,] P)
                     const float* __restrict__ data,    // ([Q,] P)
                     const float* __restrict__ ivar,    // ([Q,] P)
                     const float* __restrict__ inv_noise,  // ([Q,] P)
                     const float* __restrict__ kern,    // (B or 1, K)
                     const float* __restrict__ cont,    // (B or 1,)
                     const float* __restrict__ tmin,    // (T,) mode-1 thresholds
                     const int* __restrict__ mode,      // (T,) 0, 1 or 2
                     const int* __restrict__ prob,      // (B,) or nullptr
                     float* __restrict__ chi2,          // (B,)
                     float* __restrict__ n4,            // (B,)
                     float* __restrict__ n5,            // (B,)
                     int T, int P, int half, int tile, int kern_stride,
                     int cont_stride, int asymm) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nrank = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / nrank;
  const int tid = threadIdx.x;

  extern __shared__ float4 smem_raw[];  // 16-byte aligned line records
  float* smem = reinterpret_cast<float*>(smem_raw);
  mcalf::LineTables L;
  float* s_kern = mcalf::carve_line_tables(smem, T, L);
  const int K = 2 * half + 1;
  // [left halo | own tile | right halo], `half` + `tile` + `half` pixels
  float* own = s_kern + K + half;

  __shared__ float r_chi[kWarps];
  __shared__ int r_n4[kWarps];
  __shared__ int r_n5[kWarps];
  // CTA 0's slots for every CTA's partials, written through distributed
  // shared memory
  __shared__ float part_chi[kMaxCluster];
  __shared__ int part_n4[kMaxCluster];
  __shared__ int part_n5[kMaxCluster];

  const int p0 = rank * tile;
  const int n = min(tile, P - p0);  // pixels this CTA owns

  // Per-(sample, transition) scalars, read uniformly by every thread (the
  // loader ends in a barrier, which also publishes the taps).
  for (int k = tid; k < K; k += kThreads) s_kern[k] = kern[b * kern_stride + k];
  mcalf::load_line_tables(L, b, T, dz, gain, av, dnu, tmin, mode);

  // tau synthesis + exp, one pixel per thread per step (kDamped is the
  // host's L.any_damped), at this sample's problem's rows of the tables.
  {
    const int qrow = problem_row(prob, b, P);
    const int d0_at = qrow * T + p0;  // d0 is (Q, T, P)
    const int cw_at = qrow + p0;
    for (int i = tid; i < n; i += kThreads)
      own[i] = expf(-mcalf::tau_at<kDamped>(L, T, d0 + (d0_at + i), P, cw[cw_at + i]));
  }
  cluster.sync();  // every tile of the sample's exp(-tau) is written

  // Halo through distributed shared memory: the last `half` pixels of the
  // left neighbour (whose tile is full), the first ones of the right
  // neighbour that lie inside the spectrum.  fused_geometry keeps tile >=
  // half, so no window reaches past a neighbour.
  if (half > 0) {
    if (rank > 0) {
      const float* left = cluster.map_shared_rank(own, rank - 1);
      for (int i = tid; i < half; i += kThreads)
        own[i - half] = left[tile - half + i];
    }
    if (rank + 1 < nrank) {
      const float* right = cluster.map_shared_rank(own, rank + 1);
      for (int i = tid; i < half && p0 + n + i < P; i += kThreads)
        own[n + i] = right[i];
    }
  }
  __syncthreads();

  // LSF convolution ('same_edge': the half edge pixels of the spectrum keep
  // the unconvolved flux, so every interior tap lies inside [0, P)),
  // continuum, residuals.
  const float cb = cont[b * cont_stride];
  const int qrow = problem_row(prob, b, P);
  float chi = 0.0f;
  int c4 = 0, c5 = 0;
  for (int i = tid; i < n; i += kThreads) {
    const int p = p0 + i;
    float m = own[i];
    if (half > 0 && p >= half && p < P - half) {
      const float* row = own + (i - half);
      float acc = 0.0f;
      for (int k = 0; k < K; ++k) acc = acc + s_kern[k] * row[k];
      m = acc;
    }
    m = m * cb;
    const float r = data[qrow + p] - m;
    chi = chi + ivar[qrow + p] * r * r;
    if (asymm) {
      const float rn = r * inv_noise[qrow + p];
      c4 += rn > 4.0f;
      c5 += rn > 5.0f;
    }
  }

  // Tile reduction: warp shuffles, then one warp over the warp partials.
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
      *cluster.map_shared_rank(part_chi + rank, 0) = chi;
      *cluster.map_shared_rank(part_n4 + rank, 0) = c4;
      *cluster.map_shared_rank(part_n5 + rank, 0) = c5;
    }
  }
  // Every partial has landed in CTA 0, and every halo read is done: after
  // this no CTA touches another's shared memory, so all may leave.
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float s_chi = 0.0f;
    int s4 = 0, s5 = 0;
    for (int r = 0; r < nrank; ++r) {  // fixed order: deterministic
      s_chi += part_chi[r];
      s4 += part_n4[r];
      s5 += part_n5[r];
    }
    chi2[b] = s_chi;
    n4[b] = static_cast<float>(s4);
    n5[b] = static_cast<float>(s5);
  }
}

cudaLaunchConfig_t launch_config(int B, int cluster, int smem,
                                 cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The geometry fused_geometry gave: checked here against what the kernel
// indexes, so a wrong one is refused instead of reading out of bounds.
template <bool kDamped>
cudaError_t check_geometry(int T, int P, int half, int tile, int cluster,
                           int smem) {
  if (cluster < 1 || cluster > kMaxCluster || tile < 0 || half < 0 ||
      static_cast<long long>(tile) * cluster < P ||
      (cluster > 1 && (static_cast<long long>(tile) * (cluster - 1) >= P ||
                       tile < half)))
    return cudaErrorInvalidValue;
  const size_t need =
      sizeof(float) * (static_cast<size_t>(mcalf::kLineWords) * T +
                       (2 * half + 1) + tile + 2 * static_cast<size_t>(half));
  if (smem < 0 || static_cast<size_t>(smem) < need) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fused_loglike_kernel<kDamped>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

template <bool kDamped>
cudaError_t launch(const float* dz, const float* gain, const float* av,
                   const float* dnu, const float* d0, const float* cw,
                   const float* data, const float* ivar, const float* inv_noise,
                   const float* kern, const float* cont, const float* tmin,
                   const int* mode, const int* prob, float* chi2, float* n4,
                   float* n5, int B, int T, int P, int half, int tile,
                   int cluster, int smem, int kern_stride, int cont_stride,
                   int asymm, void* stream) {
  cudaError_t e = check_geometry<kDamped>(T, P, half, tile, cluster, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(B, cluster, smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, fused_loglike_kernel<kDamped>, dz, gain, av, dnu,
                         d0, cw, data, ivar, inv_noise, kern, cont, tmin, mode,
                         prob, chi2, n4, n5, T, P, half, tile, kern_stride,
                         cont_stride, asymm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kDamped>
cudaError_t occupancy(int T, int P, int half, int tile, int cluster, int smem,
                      int* ctas_per_sm, int* clusters) {
  cudaError_t e = check_geometry<kDamped>(T, P, half, tile, cluster, smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fused_loglike_kernel<kDamped>, kThreads,
      static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, smem, attr, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, fused_loglike_kernel<kDamped>,
                                        &cfg);
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) without synchronising.
// `prob`: nullptr for one problem, else each sample's problem index into the
// stacked d0, cw, data, ivar and inv_noise.  `damped`: some transition is in
// mode 2 (the host knows it from the mode table, voigt_cuda._any_damped).  Returns the first CUDA error: a refused
// launch (too much shared memory, a cluster that cannot be scheduled) never
// runs, and only this check reports it.
extern "C" int mcalf_fused_loglike(
    const float* dz, const float* gain, const float* av, const float* dnu,
    const float* d0, const float* cw, const float* data, const float* ivar,
    const float* inv_noise, const float* kern, const float* cont,
    const float* tmin, const int* mode, const int* prob, float* chi2,
    float* n4, float* n5, int B, int T, int P, int half, int tile,
    int cluster, int smem, int kern_stride, int cont_stride, int asymm,
    int damped, void* stream) {
  return static_cast<int>(
      (damped ? launch<true> : launch<false>)(
          dz, gain, av, dnu, d0, cw, data, ivar, inv_noise, kern, cont, tmin,
          mode, prob, chi2, n4, n5, B, T, P, half, tile, cluster, smem,
          kern_stride, cont_stride, asymm, stream));
}

// Occupancy of a geometry: CTAs of the kernel for `damped` resident on one
// SM, and clusters of `cluster` CTAs resident on the whole card at once.
extern "C" int mcalf_fused_occupancy(int T, int P, int half, int tile,
                                     int cluster, int smem, int damped,
                                     int* ctas_per_sm, int* clusters) {
  return static_cast<int>(
      (damped ? occupancy<true> : occupancy<false>)(
          T, P, half, tile, cluster, smem, ctas_per_sm, clusters));
}
