// FedAvg streaming weighted sum for Hopper: out[d] = sum_n w[n] * U[n, d].
//
// Replaces the TPU kernel src/repro/kernels/fedavg_agg.py::_agg_kernel
// (pallas_call in _aggregate_padded), which walks a 2-D grid of
// (D-tiles x client-chunks) and accumulates each D-tile in VMEM across the
// sequential client-chunk axis, its hierarchical route
// (fedavg_aggregate_tree: one _aggregate_padded per group of a tier, under
// lax.map) and its sharded route (fedavg_aggregate_sharded: per-shard
// partials, then a psum).
//
// One kernel, over up to MAX_SEGS segments: blocks of rows, each with its
// own base pointer, row count and weights (NULL: weight 1, a later tier of
// a tree).  Two modes.
// * Groups (a tree's tier, a grouped sum, the flat sum): gridDim.y block
//   rows, segment by segment, ceil(rows / F) of them a segment; block row
//   j of a segment sums its rows jF .. min(jF + F, rows) - 1 in order.
//   Rows past a segment's end are simply not there: the reference pads a
//   tier with zero rows of weight 0, whose +0.0 products leave the sum
//   bitwise as it is (an accumulator that starts at +0.0 is never -0.0),
//   so nothing is padded or copied.
// * Combine (the sharded route: every shard a card holds; a tree's last
//   tier): one block row; each segment's rows summed in order from +0.0,
//   the segment sums added in segment order in registers onto `init` (or
//   onto the first segment's sum) -- the arithmetic of one launch a shard
//   and then the partials' adds, in one launch.
//
// Bound on the H100: memory.  Every element of the update matrix is read
// exactly once and used in one multiply-add, so a launch moves 4*N*D +
// 4*N bytes in and 4*D a block row out for 2*N*D flops (0.5 flop/byte, far
// below the card's ~20 flop/byte fp32 ridge).  At N=16, D=6,603,710 that
// is 423 MB, about 126 us at 3.35 TB/s.
//
// Design: a grid of column chunks (x) by block rows (y).  Each thread owns
// COLS columns of its block row and loops over the rows, keeping the
// running sums in fp32 registers: the GPU form of Pallas's
// revisit-accumulate over the client axis, with no atomics and a fixed
// summation order (n = 0 .. N-1), so results are deterministic and equal
// bit for bit to the plain PyTorch version, which accumulates in the same
// order.  The multiply and the add are rounded separately (__fmul_rn /
// __fadd_rn) for that reason.  When D is a multiple of 4 and every buffer
// is 16-byte aligned each thread loads its 4 contiguous columns as one
// float4; otherwise neighbouring threads read neighbouring scalars (still
// coalesced).  The ragged D edge is masked in the kernel.  The segment
// table is a __grid_constant__ parameter: read in place from the
// parameter bank, never copied to local memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;  // columns per thread
constexpr int MAX_SEGS = 64;

struct Seg {
  const float* u;  // rows x D, contiguous
  const float* w;  // rows weights, or NULL: weight 1
  int64_t rows;
};

struct Segs {
  Seg s[MAX_SEGS];
  int n;
};

// this thread's COLS columns of one row (zeros past D)
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* row, int64_t base,
                                          int64_t D, float v[COLS]) {
  if (VEC) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(row + base));
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int64_t d = base + (int64_t)k * THREADS;
      v[k] = d < D ? __ldg(row + d) : 0.0f;
    }
  }
}

// acc += w[n] * u[n, cols] over rows n = lo .. hi-1 in order (WEIGHTED:
// w[n], else weight 1), each product and sum rounded on its own
template <bool VEC, bool WEIGHTED>
__device__ __forceinline__ void sum_rows(const float* __restrict__ u,
                                         const float* __restrict__ w,
                                         int64_t lo, int64_t hi, int64_t base,
                                         int64_t D, float acc[COLS]) {
  // one row an iteration: unrolled by 4, the scalar path took 57
  // registers and ran 10% slower on the H100 (PERF.md)
#pragma unroll 1
  for (int64_t n = lo; n < hi; ++n) {
    const float wn = WEIGHTED ? __ldg(w + n) : 1.0f;
    float v[COLS];
    load_cols<VEC>(u + n * D, base, D, v);
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(wn, v[k]));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fedavg_agg_kernel(const __grid_constant__ Segs segs,
                  const float* __restrict__ init, float* __restrict__ out,
                  int64_t F, int64_t D, int combine) {
  // VEC: this thread's columns base .. base+3 (all in range: D % 4 == 0);
  // else base, base + THREADS, ... (coalesced scalar loads)
  const int64_t base =
      VEC ? ((int64_t)blockIdx.x * THREADS + threadIdx.x) * COLS
          : (int64_t)blockIdx.x * THREADS * COLS + threadIdx.x;
  if (base >= D) return;
  int s0 = 0, s1 = segs.n;
  int64_t r0 = 0, r1 = 0;
  if (!combine) {  // block row y: group j of segment s
    int64_t j = blockIdx.y;
    for (;; ++s0) {
      const int64_t g = (segs.s[s0].rows + F - 1) / F;
      if (j < g) break;
      j -= g;
    }
    s1 = s0 + 1;
    r0 = j * F;
    r1 = min(r0 + F, segs.s[s0].rows);
  }
  float tot[COLS];
  if (init != nullptr) load_cols<VEC>(init, base, D, tot);
  for (int s = s0; s < s1; ++s) {
    const float* u = segs.s[s].u;
    const float* w = segs.s[s].w;
    const int64_t lo = combine ? 0 : r0;
    const int64_t hi = combine ? segs.s[s].rows : r1;
    float acc[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) acc[k] = 0.0f;
    if (w != nullptr) {
      sum_rows<VEC, true>(u, w, lo, hi, base, D, acc);
    } else {
      sum_rows<VEC, false>(u, w, lo, hi, base, D, acc);
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k)
      tot[k] = (s == s0 && init == nullptr) ? acc[k]
                                             : __fadd_rn(tot[k], acc[k]);
  }
  out += (int64_t)blockIdx.y * D;
  if (VEC) {
    *reinterpret_cast<float4*>(out + base) =
        make_float4(tot[0], tot[1], tot[2], tot[3]);
  } else {
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int64_t d = base + (int64_t)k * THREADS;
      if (d < D) out[d] = tot[k];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// table: nseg x {rows pointer, weights pointer (0: weight 1), rows} as
// int64, every segment at least one row of D contiguous f32.  combine = 0:
// out is (sum over segments of ceil(rows / F), D), block row by block row;
// combine = 1: out is (D,), init (D,) or NULL.
extern "C" int fedavg_agg_segments_launch(const int64_t* table, int nseg,
                                          const float* init, float* out,
                                          int64_t F, int64_t D, int combine,
                                          void* stream) {
  if (nseg < 1 || nseg > MAX_SEGS || D <= 0 || (!combine && F <= 0) ||
      (!combine && init != nullptr))
    return (int)cudaErrorInvalidValue;
  Segs segs;
  segs.n = nseg;
  int64_t groups = combine ? 1 : 0;
  bool aligned = D % 4 == 0 && aligned16(out) &&
                 (init == nullptr || aligned16(init));
  for (int i = 0; i < nseg; ++i) {
    Seg& sg = segs.s[i];
    sg.u = reinterpret_cast<const float*>(table[3 * i]);
    sg.w = reinterpret_cast<const float*>(table[3 * i + 1]);
    sg.rows = table[3 * i + 2];
    if (sg.u == nullptr || sg.rows <= 0) return (int)cudaErrorInvalidValue;
    if (!combine) groups += (sg.rows + F - 1) / F;
    aligned = aligned && aligned16(sg.u);  // each row then starts aligned
  }
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (int64_t)THREADS * COLS;
  const dim3 grid((unsigned)((D + per_block - 1) / per_block),
                  (unsigned)groups);
  if (aligned) {
    fedavg_agg_kernel<true><<<grid, THREADS, 0, s>>>(segs, init, out, F, D,
                                                     combine);
  } else {
    fedavg_agg_kernel<false><<<grid, THREADS, 0, s>>>(segs, init, out, F, D,
                                                      combine);
  }
  return (int)cudaGetLastError();
}
