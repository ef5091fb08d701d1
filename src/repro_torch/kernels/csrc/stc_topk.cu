// Sparse ternary compression (STC) for Hopper: the batched kernel (K2) and,
// through its wrapper, the dense one (K4).
//
// Replaces the TPU kernels src/repro/kernels/stc_topk.py::_stc_batched_kernel
// (:118, pallas_call in _stc_batched_padded) and ::_stc_kernel (:65, the dense
// stc_compress, whose (8, 1024) tiles are the 8192-element segments of one
// row: kernels/stc_topk.py::stc_compress launches this kernel on the tensor
// viewed as a (1, n) row).  For every client row and every 8192-element
// segment of it: bisect a threshold t for 16 steps so that about keep_frac of
// the segment's *real* elements exceed it, then emit sign(x) * mu on the kept
// elements (mu = their mean |x|) and 0 elsewhere, plus the per-row count of
// kept elements.
//
// Bounds on the H100.
// * Bytes: each element read once and written once, 8 bytes an element
//   (0.245 ms at 3.35 TB/s for the fc1/w leaf, 16 x 6,422,528).
// * Instructions: a bisection step compares every element and adds the
//   result, about 3 instructions an element (compare, select, half a
//   three-input add), so 16 steps over the whole segment are ~50 an
//   element: ~0.2 ms of the SMs' instruction slots at the fc1/w shape, as
//   much as the byte bound.
// * Latency: the steps are dependent block-wide reductions.  A small grid
//   (K4 at 2^20 is 128 CTAs, one wave; the small femnist leaves 16-256)
//   takes as long as one CTA's chain of loads, reductions and stores.
//
// Design.
// * The segment lives in registers.  Each of 256 threads loads its 32
//   elements once, with 16-byte loads where the segment's start is 16-byte
//   aligned (scalar loads otherwise, and at a ragged tail); the segment is
//   never staged in shared memory.
// * Loops are bounded by the segment's real length, a warp's part of a
//   group of 1024 elements at a time: slots past it are neither loaded nor
//   counted.  They would be zeros, and every threshold is > 0, so the counts
//   are the padded reference's.
// * Fewer passes over the segment.  With count(t) = #{|x| > t}, the kernel
//   keeps count(lo) and count(hi) (count(0), the non-zero elements, comes
//   with the max), so it knows how many elements lie in (lo, hi]: the only
//   ones a later step can tell apart.  It steps over the registers only
//   until at most CAP = 128 do (1-3 steps on update-like data); then it
//   gathers those candidates into shared memory, and warp 0 alone takes the
//   remaining steps on them (4 a lane, in registers), with count(mid) =
//   count(hi) + #{candidates > mid}, exact for every mid in [lo, hi], and
//   only its own hardware reduction a step.  The same thresholds, masks and
//   counts as 16 full steps, at about a third of the instructions and 4-6
//   block barriers instead of 18.  (A segment whose (lo, hi] never narrows
//   to CAP elements - one magnitude everywhere, say - takes all 16 steps
//   over the registers.)
// * One barrier a block reduction: the warp's hardware reduction
//   (redux.sync), a parity-indexed (double-buffered) scratch in shared
//   memory, which every warp then reduces itself.  The final count and the
//   double sum share one barrier.
// * 80 registers, three CTAs an SM, so that other CTAs' loads and stores
//   overlap a CTA's steps.  On the card this one configuration beat or
//   nearly matched 512- and 1024-thread CTAs, other CAPs, 96 registers and
//   a lookahead that counts the thresholds of 2-4 steps in one pass, at
//   every main-path shape, so nothing is chosen by grid size (PERF.md).
// * Arithmetic: hi starts at max|x| + 1e-12, mid = 0.5f * (lo + hi), a step
//   keeps the upper half when count > target, target = max(rintf(keep_frac *
//   real), 1): the reference's f32 operations, so thresholds, masks and
//   counts agree with it bit for bit.  mu is the kept magnitudes' sum in
//   double, divided by the count and rounded once (the plain PyTorch version
//   sums in float64 too).  Per-row counts accumulate across segments with
//   integer atomicAdd, which is exact; an all-zero row (a padded client)
//   gives mu = 0 and a count of 0.  Output stores are 16-byte streaming
//   stores where aligned.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 8192;                 // elements per threshold segment
constexpr int ITERS = 16;                 // bisection steps
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 4 * THREADS;        // elements of one group
constexpr int GROUPS = SEG / GROUP;       // a thread holds 4 of each
constexpr int CAP = 128;                  // candidates warp 0 takes over

struct Smem {
  unsigned red[2][WARPS];   // per-warp partial counts, by reduction parity
  unsigned nonzero[WARPS];
  double dsum[WARPS];
  float cand[CAP];          // the bisection's candidates
  int ncand;
  float lohi[2];
};

// -1 when |a| > t, else 0 (subtracted, so that two fold into one
// three-input add)
__device__ __forceinline__ int above(float a, float t) {
  return -(int)(fabsf(a) > t);
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// The block-wide sum of each thread's c, one barrier: every warp reduces its
// own in hardware, lane 0 writes the warp's sum to red[par] (the parity
// alternates, so a reduction never overwrites what the previous one's
// readers still read), and after the barrier every warp reduces the WARPS
// partial sums.
__device__ __forceinline__ int block_sum(int c, Smem& sm, int& par) {
  const int lane = threadIdx.x & 31;
  const unsigned w = __reduce_add_sync(0xffffffffu, (unsigned)c);
  if (lane == 0) sm.red[par][threadIdx.x >> 5] = w;
  __syncthreads();
  const unsigned r = __reduce_add_sync(
      0xffffffffu, lane < WARPS ? sm.red[par][lane] : 0u);
  par ^= 1;
  return (int)r;
}

// One (row, segment).  FULL: the segment holds SEG real elements (every
// group live, no bounds).  Thread t holds elements k * GROUP + 4t + c of
// group k (c < 4) in v[4k + c]; a warp's part of group k is live when its
// first element is real.
template <bool FULL>
__device__ __forceinline__ void segment(
    const float* __restrict__ xr, float* __restrict__ outr,
    int* __restrict__ nnz_row, int real, bool aligned, float keep_frac,
    Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = warp * 128;              // the warp's offset in a group
#define LIVE(k) (FULL || (k) * GROUP + first < real)
  float v[4 * GROUPS];
  int par = 0;

  unsigned m = 0;  // bit pattern of max |x|: non-negative floats order as ints
  int nz = 0;      // count(0): the non-zero elements
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const int e = k * GROUP + 4 * tid;
    float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (LIVE(k)) {
      if (aligned && (FULL || e + 4 <= real)) {
        q = __ldg(reinterpret_cast<const float4*>(xr + e));
      } else {
        if (FULL || e < real) q.x = __ldg(xr + e);
        if (FULL || e + 1 < real) q.y = __ldg(xr + e + 1);
        if (FULL || e + 2 < real) q.z = __ldg(xr + e + 2);
        if (FULL || e + 3 < real) q.w = __ldg(xr + e + 3);
      }
    }
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned b = __float_as_uint(fabsf(v[4 * k + c]));
      m = max(m, b);
      nz += b != 0;
    }
  }
  if (tid == 0) sm.ncand = 0;
  m = __reduce_max_sync(0xffffffffu, m);
  nz = (int)__reduce_add_sync(0xffffffffu, (unsigned)nz);
  if (lane == 0) {
    sm.red[par][warp] = m;
    sm.nonzero[warp] = (unsigned)nz;
  }
  __syncthreads();
  m = __reduce_max_sync(0xffffffffu, lane < WARPS ? sm.red[par][lane] : 0u);
  nz = (int)__reduce_add_sync(0xffffffffu,
                              lane < WARPS ? sm.nonzero[lane] : 0u);
  par ^= 1;
  const float amax = __uint_as_float(m);

  // Bisection.  cnt_lo and cnt_hi are count(lo) and count(hi), so
  // cnt_lo - cnt_hi elements lie in (lo, hi].
  const float target = fmaxf(rintf(__fmul_rn(keep_frac, (float)real)), 1.0f);
  float lo = 0.0f;
  float hi = __fadd_rn(amax, 1e-12f);
  int step = 0, cnt_lo = nz, cnt_hi = 0;
  for (; step < ITERS && cnt_lo - cnt_hi > CAP; ++step) {
    const float mid = midpoint(lo, hi);
    int c = 0;
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      if (!LIVE(k)) continue;                               // warp-uniform
      c = c - above(v[4 * k], mid) - above(v[4 * k + 1], mid)
          - above(v[4 * k + 2], mid) - above(v[4 * k + 3], mid);
    }
    c = block_sum(c, sm, par);
    if ((float)c > target) { lo = mid; cnt_lo = c; }
    else { hi = mid; cnt_hi = c; }
  }
  if (step < ITERS) {
    // gather the candidates, lo < |x| <= hi, in any order: counts need none
    int n = 0;
#pragma unroll
    for (int i = 0; i < 4 * GROUPS; ++i)
      if (LIVE(i / 4)) n += fabsf(v[i]) > lo && fabsf(v[i]) <= hi;
    int pos = n;                                    // the warp's prefix sum
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, pos, o);
      if (lane >= o) pos += y;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(&sm.ncand, pos);
    pos += __shfl_sync(0xffffffffu, base, 31) - n;
#pragma unroll
    for (int i = 0; i < 4 * GROUPS; ++i)
      if (LIVE(i / 4) && fabsf(v[i]) > lo && fabsf(v[i]) <= hi)
        sm.cand[pos++] = fabsf(v[i]);
    __syncthreads();
    if (warp == 0) {
      const int total = sm.ncand;
      float cr[CAP / 32];
#pragma unroll
      for (int j = 0; j < CAP / 32; ++j)
        cr[j] = lane + 32 * j < total ? sm.cand[lane + 32 * j] : 0.0f;
      for (; step < ITERS; ++step) {
        const float mid = midpoint(lo, hi);
        int c = 0;
#pragma unroll
        for (int j = 0; j < CAP / 32; ++j) c -= above(cr[j], mid);
        c = cnt_hi + (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
        if ((float)c > target) lo = mid; else hi = mid;
      }
      if (lane == 0) { sm.lohi[0] = lo; sm.lohi[1] = hi; }
    }
    __syncthreads();
    lo = sm.lohi[0];
    hi = sm.lohi[1];
  }
  const float t = midpoint(lo, hi);

  int kept = 0;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 4 * GROUPS; ++i) {
    const float a = fabsf(v[i]);
    if (LIVE(i / 4) && a > t) { ++kept; s += (double)a; }
  }
  // a butterfly: at every level each lane adds the same two values, so all
  // lanes end with the same, order-fixed sum
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) sm.dsum[warp] = s;
  kept = block_sum(kept, sm, par);            // its barrier covers dsum too
  s = 0.0;                                    // the same order in every thread
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += sm.dsum[w];
  const float mu = __double2float_rn(s / fmax((double)kept, 1.0));

#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    if (!LIVE(k)) continue;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = v[4 * k + c];
      o[c] = fabsf(x) > t ? copysignf(mu, x) : 0.0f;
    }
    const int e = k * GROUP + 4 * tid;
    if (aligned && (FULL || e + 4 <= real)) {
      __stcs(reinterpret_cast<float4*>(outr + e),
             make_float4(o[0], o[1], o[2], o[3]));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (FULL || e + c < real) outr[e + c] = o[c];
    }
  }
#undef LIVE
  if (nnz_row && tid == 0 && kept) atomicAdd(nnz_row, kept);
}

__global__ void __launch_bounds__(THREADS, 3)
stc_kernel(const float* __restrict__ x, float* __restrict__ out,
           int* __restrict__ nnz, int64_t D, float keep_frac) {
  __shared__ Smem sm;
  const int64_t row = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * SEG;
  const int real = (int)((D - start) < SEG ? (D - start) : SEG);
  const float* xr = x + row * D + start;
  float* outr = out + row * D + start;
  const bool aligned = ((reinterpret_cast<uintptr_t>(xr) |
                         reinterpret_cast<uintptr_t>(outr)) & 15) == 0;
  int* nnz_row = nnz ? nnz + row : nullptr;
  if (real == SEG)
    segment<true>(xr, outr, nnz_row, real, aligned, keep_frac, sm);
  else
    segment<false>(xr, outr, nnz_row, real, aligned, keep_frac, sm);
}

}  // namespace

// nnz may be null: the counts are then neither zeroed nor written (the dense
// path, K4, discards them).
extern "C" int stc_batched_launch(const float* x, float* out, int* nnz,
                                  int64_t N, int64_t D, float keep_frac,
                                  void* stream) {
  if (N <= 0 || D <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nnz) {
    const cudaError_t err = cudaMemsetAsync(nnz, 0, sizeof(int) * N, s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((D + SEG - 1) / SEG), (unsigned)N);
  stc_kernel<<<grid, THREADS, 0, s>>>(x, out, nnz, D, keep_frac);
  return (int)cudaGetLastError();
}
