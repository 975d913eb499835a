// The slice sampler's per-iteration bookkeeping for Hopper (sm_90a): two
// kernels around the likelihood call of one chord-bracket slice iteration
// (mcalf_torch/sampler/nested.py::_slice_step), in place of the about 70
// PyTorch elementwise launches of its torch-op body.
//
// Replaces no TPU kernel: the JAX package's slice loop body
// (mcalf_tpu/sampler/nested.py::_slice_chains' lax.while_loop) is fused by
// XLA into the device program.  Here each op of the body was one launch of
// about 1.5 us on at most a few hundred thousand floats, so the loop waited
// on launch latency, not on bytes: the (Q, B, ndim) carry and the direction
// pool's row are well under 1 MB a call, about 0.3 us at 3.35 TB/s.  So the
// design is two launches, each a single pass over the rows, nothing staged
// through device memory but the four buffers slice_propose hands on.
//
//   * slice_propose: one CTA per problem, kRow threads a chain (row).  It
//     reads the carry's point, direction and bracket, the chain's passes,
//     the loop's iteration count and the iteration's uniform draw, and
//     writes `running`, the proposal's `t`, `inside` (the proposal lies in
//     the unit cube) and the clamped proposal `u_eval`, which the likelihood
//     launch reads; and n_like[q] += B * any(running[q, :]), a block
//     reduction over the problem's CTA, so no atomics.
//   * slice_update: CTAs of 64 threads over the rows, kRow threads a row, so
//     that a problem's rows spread over many SMs and a row's loads are in
//     flight together.  On an H100 at the flagship's 100 rows of 34 a
//     launch takes about 4 us and slice_propose about 3: two or three
//     dependent trips to memory and the launch's own cost, not bytes or
//     arithmetic.  It does accept / reject / shrink, the pass counters, the
//     next pass's direction (a row of the pool) and its cube-chord bracket,
//     the stores into the carry, the active-row counter and (one thread of
//     CTA 0) the iteration count, which slice_propose alone reads.
//
// Bit for bit the torch ops' result, so that every trajectory and every file
// a fit writes stays what the torch ops give:
//   * every float operation is rounded as PyTorch's own elementwise kernel
//     rounds it, one op at a time (__fadd_rn and friends: nvcc would
//     otherwise contract a*b + c into a fused multiply-add); the bracket's
//     divisions are IEEE (__fdiv_rn), and 0 - u is a subtraction (0 - 0 is
//     +0 where -0 is not);
//   * NaN (a pool direction whose Cholesky factor failed) follows PyTorch's
//     CUDA kernels: clamp, minimum / maximum and amax / amin propagate it.
// One thing is left to the reduction order: where the bracket's amax / amin
// meets a +0 and a -0 (a point on a face), which of the two it returns.  That
// sign reaches nothing: lo <= 0 <= hi, and t = lo + r (hi - lo) is the same
// value whichever sign a zero end has, so the bracket ends are equal to the
// torch ops' by value and every other output bit for bit.
// The kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// the threads of a row (chain) in both kernels, a power of two up to a warp
constexpr int kRow = 8;
// slice_propose: one CTA per problem, of at most kProposeThreads threads
constexpr int kProposeThreads = 1024;
// slice_update: CTAs of kUpdateThreads threads over the rows
constexpr int kUpdateThreads = 64;

// torch.minimum / torch.maximum on CUDA: a NaN operand, else fminf / fmaxf.
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float torch_maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.amax / torch.amin's combine (MaxNanFunctor / MinNanFunctor).
__device__ __forceinline__ float amax_combine(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float amin_combine(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
// torch.clamp(v, 0, 1) on CUDA: NaN kept, else min(max(v, 0), 1).
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// t = lo + r (hi - lo), each op rounded on its own.
__device__ __forceinline__ float proposal_t(float lo, float hi, float r) {
  return __fadd_rn(lo, __fmul_rn(r, __fsub_rn(hi, lo)));
}

// u + t d, each op rounded on its own.
__device__ __forceinline__ float proposal_u(float u, float t, float d) {
  return __fadd_rn(u, __fmul_rn(t, d));
}

// The mask of the kRow threads of a warp that hold this thread's row.
__device__ __forceinline__ unsigned row_mask() {
  return kRow == kWarp ? kFull : ((1u << kRow) - 1u) << (threadIdx.x % kWarp / kRow * kRow);
}

__global__ void __launch_bounds__(kProposeThreads)
slice_propose_kernel(const float* __restrict__ u, const float* __restrict__ d,
                     const float* __restrict__ lo, const float* __restrict__ hi,
                     const int* __restrict__ passes, const int* __restrict__ it_total,
                     const float* __restrict__ r, bool* __restrict__ running,
                     float* __restrict__ t_out, bool* __restrict__ inside,
                     float* __restrict__ u_eval, long long* __restrict__ n_like, int B,
                     int ndim, int nrep, int total_cap) {
  const int q = blockIdx.x;
  const int p = threadIdx.x % kRow;
  const unsigned mask = row_mask();
  const bool below_cap = *it_total < total_cap;
  bool any_running = false;
  for (int b = threadIdx.x / kRow; b < B; b += blockDim.x / kRow) {
    const int row = q * B + b;
    const float t = proposal_t(lo[row], hi[row], r[row]);
    const size_t base = static_cast<size_t>(row) * ndim;
    bool in = true;
    for (int e = p; e < ndim; e += kRow) {
      const float up = proposal_u(u[base + e], t, d[base + e]);
      in = in && up >= 0.0f && up <= 1.0f;
      u_eval[base + e] = clamp01(up);
    }
    in = __all_sync(mask, in);
    const bool run = passes[row] < nrep && below_cap;
    any_running = any_running || run;
    if (p == 0) {
      running[row] = run;
      t_out[row] = t;
      inside[row] = in;
    }
  }
  // n_like[q] += B * any(running[q, :])
  if (__syncthreads_or(any_running) && threadIdx.x == 0) n_like[q] += B;
}

__global__ void __launch_bounds__(kUpdateThreads)
slice_update_kernel(float* __restrict__ u, float* __restrict__ logl,
                    float* __restrict__ d, float* __restrict__ lo,
                    float* __restrict__ hi, int* __restrict__ it_pass,
                    int* __restrict__ passes, int* __restrict__ it_total,
                    long long* __restrict__ active, const float* __restrict__ pools,
                    const float* __restrict__ lstar, const float* __restrict__ ll,
                    const bool* __restrict__ running, const float* __restrict__ t_in,
                    const bool* __restrict__ inside, int rows, int B, int ndim, int nrep,
                    int max_shrink) {
  // the loop's iteration count, which slice_propose alone reads
  if (blockIdx.x == 0 && threadIdx.x == 0) *it_total += 1;
  const int p = threadIdx.x % kRow;
  const int row = blockIdx.x * (kUpdateThreads / kRow) + threadIdx.x / kRow;
  if (row >= rows) return;  // the row's threads together
  const int q = row / B, b = row % B;
  const size_t base = static_cast<size_t>(row) * ndim;
  const bool run = running[row];
  const float t = t_in[row];
  const float ll_prop = inside[row] ? ll[row] : -INFINITY;
  const bool acc = ll_prop > lstar[q] && run;
  const bool rej = run && !acc;
  const int it1 = rej ? it_pass[row] + 1 : it_pass[row];
  const bool fin = acc || (rej && it1 >= max_shrink);
  const int passes1 = passes[row] + (fin ? 1 : 0);
  const bool need = fin && passes1 < nrep;
  if (acc || need) {
    // the accepted point, and for the next pass its direction (a row of the
    // pool) and that direction's cube chord (nested.py::_bracket: lo = amax
    // min(c1, c2), hi = amin max(c1, c2), c1 = (0 - u) / safe_d,
    // c2 = (1 - u) / safe_d), each thread over every kRow-th element
    const int pass = passes1 < nrep - 1 ? passes1 : nrep - 1;
    const float* dn = pools + ((static_cast<size_t>(q) * nrep + pass) * B + b) * ndim;
    float mx = -INFINITY, mn = INFINITY;
    for (int e = p; e < ndim; e += kRow) {
      float uc = u[base + e];
      if (acc) {
        uc = proposal_u(uc, t, d[base + e]);
        u[base + e] = uc;
      }
      if (need) {
        const float dk = dn[e];
        d[base + e] = dk;
        const float sd = fabsf(dk) < 1e-12f ? 1e-12f : dk;
        const float c1 = __fdiv_rn(__fsub_rn(0.0f, uc), sd);
        const float c2 = __fdiv_rn(__fsub_rn(1.0f, uc), sd);
        mx = amax_combine(mx, torch_minimum(c1, c2));
        mn = amin_combine(mn, torch_maximum(c1, c2));
      }
    }
    if (need) {
      for (int off = kRow / 2; off > 0; off >>= 1) {
        mx = amax_combine(mx, __shfl_down_sync(row_mask(), mx, off, kRow));
        mn = amin_combine(mn, __shfl_down_sync(row_mask(), mn, off, kRow));
      }
      if (p == 0) {
        lo[row] = mx;
        hi[row] = mn;
      }
    }
  }
  if (p == 0) {
    if (!need && rej) {
      // rejection shrinks the bracket toward the (unchanged) current point
      if (t < 0.0f) lo[row] = t;
      if (t >= 0.0f) hi[row] = t;
    }
    if (acc) logl[row] = ll_prop;
    it_pass[row] = fin ? 0 : it1;
    passes[row] = passes1;
    if (active != nullptr) active[row] += run ? 1 : 0;
  }
}

}  // namespace

// One chord slice iteration's proposals of Q problems' B chains (see above),
// and n_like's count of this iteration's evaluations.
extern "C" int mcalf_slice_propose(const float* u, const float* d, const float* lo,
                                   const float* hi, const int* passes,
                                   const int* it_total, const float* r, bool* running,
                                   float* t, bool* inside, float* u_eval,
                                   long long* n_like, int Q, int B, int ndim, int nrep,
                                   int total_cap, void* stream) {
  int threads = ((B * kRow + kWarp - 1) / kWarp) * kWarp;
  threads = threads < kProposeThreads ? threads : kProposeThreads;
  slice_propose_kernel<<<Q, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, d, lo, hi, passes, it_total, r, running, t, inside, u_eval, n_like, B, ndim,
      nrep, total_cap);
  return static_cast<int>(cudaGetLastError());
}

// The same iteration's update of the chains in place, after the likelihood
// `ll` (Q * B) of slice_propose's u_eval; `active` may be null.
extern "C" int mcalf_slice_update(float* u, float* logl, float* d, float* lo, float* hi,
                                  int* it_pass, int* passes, int* it_total,
                                  long long* active, const float* pools,
                                  const float* lstar, const float* ll,
                                  const bool* running, const float* t,
                                  const bool* inside, int Q, int B, int ndim, int nrep,
                                  int max_shrink, void* stream) {
  constexpr int rows_per_cta = kUpdateThreads / kRow;
  const int grid = (Q * B + rows_per_cta - 1) / rows_per_cta;
  slice_update_kernel<<<grid, kUpdateThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, logl, d, lo, hi, it_pass, passes, it_total, active, pools, lstar, ll, running,
      t, inside, Q * B, B, ndim, nrep, max_shrink);
  return static_cast<int>(cudaGetLastError());
}
