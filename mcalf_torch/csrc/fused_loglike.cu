// Fused Voigt likelihood for Hopper (sm_90a): tau -> exp(-tau) -> LSF
// convolution ('same_edge') -> continuum -> chi^2 (+ asymmetric-likelihood
// outlier counts), each sample's spectrum split over one thread block
// cluster, nothing through device memory but the three (B,) outputs.
//
// Replaces the two fused Pallas TPU kernels of mcalf_tpu/ops/voigt_pallas.py,
// _ll_kernel and _ll_kernel_win.  The TPU needed a window table because its
// vector unit evaluates both sides of a select; here a per-pixel branch skips
// the work a pixel does not need by itself, so ONE kernel computes every
// line's H in its mode (voigt_h.cuh): plain Harris (mode 0), the
// hjert_harris_win selection (mode 1: u^2 < tmin takes the full Harris
// expansion, the rest the 7-term wing polynomial), or full hjert (mode 2:
// Algorithm 916 where u^2 + a^2 < 111, the asymptotic form elsewhere).  The
// mode table sets modes 0 and 1 per transition; mode 2 is chosen per line
// from the row's own damping and gain (voigt_h.cuh line_mode), since a
// transition whose prior allows strong damping is weakly damped in most
// rows.  That is _ll_kernel's value to within Harris's accuracy below
// HARRIS_A_MAX, and _ll_kernel_win's to within its own
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
//     (voigt_cuda._any_damped), both in 48 registers, 5 CTAs (40 warps) per
//     SM.  One with a transition that may be strongly damped calls the
//     non-inlined 916 series, whose minus-term loops stay loops so that its
//     frame fits the same budget (it runs on a small share of the pairs;
//     the Harris lines of every row run at the full occupancy), and counts
//     the lines that took mode 2 (hjert_lines_count) and the pairs that
//     took the series (series_evals_count).
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
//   * Two sources of rows (kCube, a compile-time choice beside kDamped, set
//     by the entry point the host calls).  Given (B, T) line tables, the
//     kernel writes chi^2 and the asymmlike counts, and the host adds the
//     rest of log L.  Given the rows' unit-cube points (the sampler's call),
//     each CTA makes its row's line records, taps and continuum from the
//     point in its prologue and CTA 0 writes log L: the about 39 PyTorch
//     launches the host issued around each call (the cube transform, the
//     per-row gathers of a stacked batch's constants, the line tables, the
//     likelihood's tail) become this one launch, with the same float32
//     rounding at each step.
// Shared memory holds the line tables, the taps and one tile plus its halo,
// so the spectrum's length no longer bounds it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// Where a launch's per-row inputs come from and what it writes: the
// kernel's second template parameter, kCube, picks one of these two.
//
// TableRows: the (B, T) line scalars, LSF taps and continua a caller made
// (models/torch_model.py's fused_args, for loglike_core(p), chi2 and the
// analysis); the kernel writes chi^2 and the asymmlike counts.
struct TableRows {
  const float* dz;    // (B, T)
  const float* gain;  // (B, T)
  const float* av;    // (B, T)
  const float* dnu;   // (B, T)
  const float* kern;  // (B or 1, K)
  const float* cont;  // (B or 1,)
  float* chi2;        // (B,)
  float* n4;          // (B,)
  float* n5;          // (B,)
  int kern_stride, cont_stride;
};

// CubeRows: the rows' unit-cube points (the sampler's loglike_cube).  The
// kernel makes each row's line records, taps and continuum from its point
// in the prologue and writes log L in the epilogue, by the float32
// operations of the PyTorch glue it replaces (models/torch_model.py's
// loglike_cube_core: cube_to_params_core, _line_tables, fused_args,
// loglike_from_fused) in the same order, each rounded as PyTorch's own
// elementwise kernels round it (__fmul_rn and friends, so that nothing is
// contracted into a fused multiply-add).  Per-problem tables are
// ([Q,] ...) and read at row prob[b] (row 0 without a problem axis), as the
// spectra are.
struct CubeRows {
  const float* u;             // (B, ndim)
  const float* lo;            // ([Q,] ndim) prior box
  const float* hi;            // ([Q,] ndim)
  const float* zspan;         // ([Q,] T)
  const float* inv_wrest_cm;  // ([Q,] T)
  const float* gamma;         // ([Q,] T)
  const float* f;             // ([Q,] T)
  const float* taps;          // ([Q,] K); nullptr: built from the row's resolution
  const float* velstep;       // ([Q,]) (a free resolution)
  const float* contval;       // ([Q,]) (a fixed continuum)
  const float* const_term;    // ([Q,])
  const float* cdf4;          // ([Q,])
  const float* cdf5;          // ([Q,])
  const float* grace;         // ([Q,])
  const float* gp_mu;         // ([Q,] ndim); nullptr: no Gaussian priors
  const float* gp_isig2;      // ([Q,] ndim)
  const float* gp_norm;       // ([Q,])
  const long long* pidx;      // (T,) column of the transition's log N
  const long long* u_zidx;    // (T,) column of its redshift
  const float* comp_id;       // (T,)
  const bool* is_fill;        // (T,)
  float* loglike;             // (B,)
  int ndim, startind;
  int specres_at, cont_at;    // columns of a free resolution / continuum, else -1
};

// The lines that took mode 2, summed over every launch of a damped
// instantiation since the library was loaded (one atomic per row, from the
// row's list of them in CTA 0): what
// voigt_cuda.hjert_lines reads.  A static symbol, so a launch captured in a
// CUDA graph adds at each replay and nothing is allocated at capture.
__device__ unsigned long long hjert_lines_count = 0;
// The (line, pixel) pairs that took the Algorithm 916 series, likewise: one
// atomic per CTA from its shared count (voigt_h.cuh series_pairs); what
// voigt_cuda.series_evals reads.
__device__ unsigned long long series_evals_count = 0;

// A cube launch's row constants, left in shared memory by the prologue so
// that nothing of the cube path stays live across the pixel loop: the
// continuum, const_term, cdf4 + grace, cdf5 + grace and the Gaussian
// priors' term.
__shared__ float cube_row[5];

// Parameter j of row b of problem q: lo + u (hi - lo), the cube transform.
__device__ __forceinline__ float cube_param(const CubeRows& r, int b, int q, int j) {
  const float lo = r.lo[q * r.ndim + j];
  return __fadd_rn(lo, __fmul_rn(r.u[b * r.ndim + j], __fsub_rn(r.hi[q * r.ndim + j], lo)));
}

// Tap `tid` of a free resolution's LSF, gaussian_kernel(((specres /
// FWHM_TO_SIGMA) / velstep), half): the thread sums all K exponentials
// itself (in tap order; PyTorch's reduction takes another order), so no
// barrier is needed before the division.  Out of line: inlined, its expf
// loop cost the damped instantiation 20 more bytes of spills, and the
// flagship, whose resolution is fixed, never takes it.
__device__ __noinline__ void free_taps(const CubeRows& r, float* s_kern, int b, int q,
                                       int half, int tid) {
  const int K = 2 * half + 1;
  const float sg = __fdiv_rn(
      __fmul_rn(cube_param(r, b, q, r.specres_at), MCALF_INV_FWHM_TO_SIGMA), r.velstep[q]);
  const float den = __fmul_rn(2.0f, __fmul_rn(sg, sg));
  float sum = 0.0f, mine = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float x = static_cast<float>(k - half);
    const float e = expf(__fdiv_rn(-__fmul_rn(x, x), den));
    sum = __fadd_rn(sum, e);
    if (k == tid) mine = e;
  }
  s_kern[tid] = __fdiv_rn(mine, sum);
}

// The prologue of a cube launch: row b's line records, LSF taps and row
// constants in shared memory, one thread per transition, per tap and (thread
// 0) for the constants.  Every thread takes part and sees the filled tables
// on return.
template <bool kDamped>
__device__ __forceinline__ void load_cube_tables(const CubeRows& r, mcalf::LineTables& L,
                                                 float* s_kern, int b, int q, int T,
                                                 int half, const float* __restrict__ tmin,
                                                 const int* __restrict__ mode) {
  const int tid = threadIdx.x;
  const int K = 2 * half + 1;
  if (r.taps != nullptr) {
    for (int k = tid; k < K; k += kThreads) s_kern[k] = r.taps[q * K + k];
  } else if (half > 0 && tid < K) {
    free_taps(r, s_kern, b, q, half, tid);
  }
  if (tid == 0) {
    cube_row[0] = r.cont_at < 0 ? r.contval[q] : cube_param(r, b, q, r.cont_at);
    cube_row[1] = r.const_term[q];
    cube_row[2] = __fadd_rn(r.cdf4[q], r.grace[q]);
    cube_row[3] = __fadd_rn(r.cdf5[q], r.grace[q]);
    if (r.gp_mu != nullptr) {
      float s = 0.0f;
      for (int j = 0; j < r.ndim; ++j) {
        const float d = __fsub_rn(cube_param(r, b, q, j), r.gp_mu[q * r.ndim + j]);
        s = __fadd_rn(s, __fmul_rn(__fmul_rn(d, d), r.gp_isig2[q * r.ndim + j]));
      }
      cube_row[4] = __fmul_rn(0.5f, __fadd_rn(s, r.gp_norm[q]));
    }
  }
  const float nact = floorf(cube_param(r, b, q, r.startind));
  int damped = 0, harris = 0;
  for (int t = tid; t < T; t += kThreads) {
    const int qt = q * T + t;
    const int j = static_cast<int>(r.pidx[t]);
    const float logn = cube_param(r, b, q, j);
    const float bkms = cube_param(r, b, q, j + 2);
    const float dz = __fmul_rn(
        __fsub_rn(r.u[b * r.ndim + static_cast<int>(r.u_zidx[t])], 0.5f), r.zspan[qt]);
    const float dnu = __fmul_rn(__fmul_rn(bkms, 1e5f), r.inv_wrest_cm[qt]);
    const float av = __fdiv_rn(r.gamma[qt], __fmul_rn(MCALF_FOUR_PI, dnu));
    const float amp = __fdiv_rn(
        __fmul_rn(__fmul_rn(MCALF_TAU_CONST, powf(10.0f, logn)), r.f[qt]), dnu);
    const float active = (r.comp_id[t] < nact) | r.is_fill[t] ? 1.0f : 0.0f;
    const int m =
        mcalf::put_line<kDamped>(L, t, dz, dnu, __fmul_rn(active, amp), av, tmin, mode);
    damped |= m == 2;
    harris |= m != 2;
  }
  mcalf::finish_line_tables<kDamped>(L, T, damped, harris);
}

// The epilogue of a cube launch: log L = -0.5 (chi^2 + const_term), -inf
// where the asymmlike counts pass cdf + grace, less the Gaussian priors'
// term (the prologue's sum over the parameters in column order; PyTorch's
// reduction takes another), from the row constants the prologue left.
__device__ __forceinline__ float cube_loglike(const CubeRows& r, float chi, int c4, int c5,
                                              int asymm) {
  float ll = __fmul_rn(-0.5f, __fadd_rn(chi, cube_row[1]));
  if (asymm && (static_cast<float>(c5) > cube_row[3] || static_cast<float>(c4) > cube_row[2]))
    ll = __int_as_float(0xff800000);  // -inf
  if (r.gp_mu != nullptr) ll = __fsub_rn(ll, cube_row[4]);
  return ll;
}

template <bool kCube>
using Rows = typename std::conditional<kCube, CubeRows, TableRows>::type;

// Resident CTAs per SM the registers must allow: 5 x 8 = 40 warps (48
// registers) in all four instantiations; the damped ones' Algorithm-916
// call takes its register-lean form (wofz_real_916<true>) to fit them.
// kCube changes the prologue and the epilogue only: the pixel loop, the
// halo, the LSF and the reductions are the same code in all four
// instantiations, and each cube instantiation keeps its table twin's
// registers and spills.  `rows` is a grid constant, so free_taps reads it
// where the launch put it, without a local copy.
template <bool kDamped, bool kCube>
__global__ void __launch_bounds__(kThreads, 5)
fused_loglike_kernel(const __grid_constant__ Rows<kCube> rows,
                     const float* __restrict__ d0,      // ([Q,] T, P)
                     const float* __restrict__ cw,      // ([Q,] P)
                     const float* __restrict__ data,    // ([Q,] P)
                     const float* __restrict__ ivar,    // ([Q,] P)
                     const float* __restrict__ inv_noise,  // ([Q,] P)
                     const float* __restrict__ tmin,    // (T,) mode-1 thresholds
                     const int* __restrict__ mode,      // (T,) 0, 1 or 2
                     const int* __restrict__ prob,      // (B,) or nullptr
                     int T, int P, int half, int tile, int asymm) {
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
  if constexpr (kCube) {
    load_cube_tables<kDamped>(rows, L, s_kern, b, prob == nullptr ? 0 : prob[b], T, half,
                              tmin, mode);
  } else {
    for (int k = tid; k < K; k += kThreads)
      s_kern[k] = rows.kern[b * rows.kern_stride + k];
    mcalf::load_line_tables<kDamped>(L, b, T, rows.dz, rows.gain, rows.av, rows.dnu, tmin,
                                     mode);
  }

  // tau synthesis + exp, one pixel per thread per step (kDamped is the
  // host's choice from the mode table), at this sample's problem's rows of
  // the tables.
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
  float cb;
  if constexpr (kCube) {
    cb = cube_row[0];
  } else {
    cb = rows.cont[b * rows.cont_stride];
  }
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
  if constexpr (kDamped) {  // the CTA's series pairs, one atomic a CTA
    if (tid == 0 && mcalf::series_pairs != 0)
      atomicAdd(&series_evals_count, static_cast<unsigned long long>(mcalf::series_pairs));
  }
  if (rank == 0 && tid == 0) {
    float s_chi = 0.0f;
    int s4 = 0, s5 = 0;
    for (int r = 0; r < nrank; ++r) {  // fixed order: deterministic
      s_chi += part_chi[r];
      s4 += part_n4[r];
      s5 += part_n5[r];
    }
    if constexpr (kCube) {
      rows.loglike[b] = cube_loglike(rows, s_chi, s4, s5, asymm);
    } else {
      rows.chi2[b] = s_chi;
      rows.n4[b] = static_cast<float>(s4);
      rows.n5[b] = static_cast<float>(s5);
    }
    if constexpr (kDamped) {  // the row's mode-2 lines, one atomic a row
      int nh = 0;
      for (int t = mcalf::any_hjert; t < T; t = __float_as_int(L.rec[2 * t + 1].x)) ++nh;
      if (nh > 0) atomicAdd(&hjert_lines_count, static_cast<unsigned long long>(nh));
    }
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
template <bool kDamped, bool kCube>
cudaError_t check_geometry(int T, int P, int half, int tile, int cluster,
                           int smem) {
  if (cluster < 1 || cluster > kMaxCluster || tile < 0 || half < 0 ||
      static_cast<long long>(tile) * cluster < P ||
      (cluster > 1 && (static_cast<long long>(tile) * (cluster - 1) >= P ||
                       tile < half)))
    return cudaErrorInvalidValue;
  if (kCube && 2 * half + 1 > kThreads) return cudaErrorInvalidValue;  // a tap per thread
  const size_t need =
      sizeof(float) * (static_cast<size_t>(mcalf::kLineWords) * T +
                       (2 * half + 1) + tile + 2 * static_cast<size_t>(half));
  if (smem < 0 || static_cast<size_t>(smem) < need) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(fused_loglike_kernel<kDamped, kCube>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return cudaSuccess;
}

// What every launch reads besides its rows: the spectra, the mode table,
// the problem axis and the geometry.
struct Spectra {
  const float *d0, *cw, *data, *ivar, *inv_noise, *tmin;
  const int *mode, *prob;
  int B, T, P, half, tile, cluster, smem, asymm;
};

template <bool kDamped, bool kCube>
cudaError_t launch(const Rows<kCube>& rows, const Spectra& sp, void* stream) {
  cudaError_t e = check_geometry<kDamped, kCube>(sp.T, sp.P, sp.half, sp.tile,
                                                 sp.cluster, sp.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(sp.B, sp.cluster, sp.smem, attr, stream);
  e = cudaLaunchKernelEx(&cfg, fused_loglike_kernel<kDamped, kCube>, rows, sp.d0, sp.cw,
                         sp.data, sp.ivar, sp.inv_noise, sp.tmin, sp.mode, sp.prob,
                         sp.T, sp.P, sp.half, sp.tile, sp.asymm);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kDamped, bool kCube>
cudaError_t occupancy(int T, int P, int half, int tile, int cluster, int smem,
                      int* ctas_per_sm, int* clusters) {
  cudaError_t e = check_geometry<kDamped, kCube>(T, P, half, tile, cluster, smem);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, fused_loglike_kernel<kDamped, kCube>, kThreads,
      static_cast<size_t>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, smem, attr, nullptr);
  return cudaOccupancyMaxActiveClusters(clusters, fused_loglike_kernel<kDamped, kCube>,
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
  const TableRows rows = {dz, gain, av, dnu, kern, cont, chi2, n4, n5,
                          kern_stride, cont_stride};
  const Spectra sp = {d0, cw, data, ivar, inv_noise, tmin, mode, prob,
                      B, T, P, half, tile, cluster, smem, asymm};
  return static_cast<int>(
      (damped ? launch<true, false> : launch<false, false>)(rows, sp, stream));
}

// The same launch from the rows' unit-cube points: each row's line records,
// taps and continuum made in the kernel's prologue (CubeRows), log L
// written.  The per-problem tables are ([Q,] ...) like d0's problem axis;
// `taps` nullptr builds them from column `specres_at`, `cont_at` -1 reads
// `contval`, `gp_mu` nullptr adds no Gaussian priors.
extern "C" int mcalf_fused_loglike_cube(
    const float* u, const float* lo, const float* hi, const float* zspan,
    const float* inv_wrest_cm, const float* gamma, const float* f,
    const float* taps, const float* velstep, const float* contval,
    const float* const_term, const float* cdf4, const float* cdf5,
    const float* grace, const float* gp_mu, const float* gp_isig2,
    const float* gp_norm, const long long* pidx, const long long* u_zidx,
    const float* comp_id, const bool* is_fill, const float* d0,
    const float* cw, const float* data, const float* ivar,
    const float* inv_noise, const float* tmin, const int* modes,
    const int* prob, float* loglike, int B, int T, int P, int half, int tile,
    int cluster, int smem, int ndim, int startind, int specres_at,
    int cont_at, int asymm, int damped, void* stream) {
  const CubeRows rows = {u, lo, hi, zspan, inv_wrest_cm, gamma, f, taps,
                         velstep, contval, const_term, cdf4, cdf5, grace,
                         gp_mu, gp_isig2, gp_norm, pidx, u_zidx, comp_id,
                         is_fill, loglike, ndim, startind, specres_at, cont_at};
  const Spectra sp = {d0, cw, data, ivar, inv_noise, tmin, modes, prob,
                      B, T, P, half, tile, cluster, smem, asymm};
  return static_cast<int>(
      (damped ? launch<true, true> : launch<false, true>)(rows, sp, stream));
}

namespace {

// A device counter's value on `device`, once every launch issued to it has
// run: the one read of the counter, which synchronises the device.
int read_counter(const unsigned long long& symbol, int device, unsigned long long* out) {
  int was = 0;
  cudaError_t e = cudaGetDevice(&was);
  if (e == cudaSuccess) e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, symbol, sizeof(*out));
  const cudaError_t back = cudaSetDevice(was);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

}  // namespace

// The fused launches' mode-2 lines on `device` (hjert_lines_count).
// Returns the first CUDA error.
extern "C" int mcalf_fused_hjert_lines(int device, unsigned long long* out) {
  return read_counter(hjert_lines_count, device, out);
}

// The fused launches' (line, pixel) pairs on `device` that took the 916
// series (series_evals_count).  Returns the first CUDA error.
extern "C" int mcalf_fused_series_evals(int device, unsigned long long* out) {
  return read_counter(series_evals_count, device, out);
}

// Occupancy of a geometry: CTAs of the kernel for `damped` and `cube`
// resident on one SM, and clusters of `cluster` CTAs resident on the whole
// card at once.
extern "C" int mcalf_fused_occupancy(int T, int P, int half, int tile,
                                     int cluster, int smem, int damped, int cube,
                                     int* ctas_per_sm, int* clusters) {
  auto fn = damped ? (cube ? occupancy<true, true> : occupancy<true, false>)
                   : (cube ? occupancy<false, true> : occupancy<false, false>);
  return static_cast<int>(fn(T, P, half, tile, cluster, smem, ctas_per_sm, clusters));
}
