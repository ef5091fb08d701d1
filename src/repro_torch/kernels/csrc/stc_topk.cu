// Batched sparse ternary compression (STC) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/stc_topk.py::_stc_batched_kernel
// (pallas_call in _stc_batched_padded).  For every client row and every
// 8192-element segment of it: bisect a threshold t for 16 steps so that
// about keep_frac of the segment's *real* elements exceed it, then emit
// sign(x) * mu on the kept elements (mu = their mean |x|) and 0 elsewhere,
// plus the per-row count of kept elements.
//
// Bound on the H100: memory for the data (each element read once and
// written once: 8 bytes per element), but the 17 dependent block-wide
// reductions per segment (max, 16 bisection counts) make it latency-bound
// in practice; the counting itself is ~2 * 17 operations per element.
//
// Design: one CTA per (row, segment).  The segment is staged in shared
// memory once (32 KB) and every bisection step re-reads it from there, so
// device memory is touched once in each direction.  Counts are exact
// integers from warp-shuffle + shared-memory block reductions, and the
// bisection arithmetic (mid = 0.5f * (lo + hi), the count > target test,
// target = max(rintf(keep_frac * real), 1)) is the same sequence of f32
// operations as the reference, so thresholds, masks and counts agree bit
// for bit with it.  The sum behind mu is accumulated in double and rounded
// once, which makes mu independent of the reduction order (the plain
// PyTorch version sums in float64 too).  Per-row counts accumulate across
// segments with integer atomicAdd, which is exact.  An all-zero row (a
// padded client) gives mu = 0 and a count of 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SEG = 8192;        // elements per threshold segment
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITERS = 16;        // bisection steps

struct MaxI { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct SumI { __device__ int operator()(int a, int b) const { return a + b; } };
struct SumD { __device__ double operator()(double a, double b) const { return a + b; } };

// Block-wide reduction whose result every thread receives.  The order of
// operations is fixed, so the result is deterministic.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // scratch may still be read by the previous reduction
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = scratch[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = op(r, scratch[i]);
  return r;
}

__global__ void __launch_bounds__(THREADS)
stc_batched_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int* __restrict__ nnz, int64_t D, float keep_frac) {
  __shared__ float seg[SEG];
  __shared__ int iscratch[WARPS];
  __shared__ double dscratch[WARPS];

  const int64_t row = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * SEG;
  const int real = (int)((D - start) < SEG ? (D - start) : SEG);
  const float* xr = x + row * D + start;
  float* outr = out + row * D + start;

  // stage the segment; the padded tail reads as 0, as in the reference
  int lmax = 0;  // bit pattern of max |x|: non-negative floats order as ints
  for (int i = threadIdx.x; i < SEG; i += THREADS) {
    const float v = i < real ? xr[i] : 0.0f;
    seg[i] = v;
    lmax = max(lmax, __float_as_int(fabsf(v)));
  }
  const float amax = __int_as_float(block_reduce(lmax, MaxI(), iscratch));

  const float target = fmaxf(rintf(__fmul_rn(keep_frac, (float)real)), 1.0f);
  float lo = 0.0f;
  float hi = __fadd_rn(amax, 1e-12f);
  for (int it = 0; it < ITERS; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
    for (int i = threadIdx.x; i < SEG; i += THREADS) c += fabsf(seg[i]) > mid;
    const int count = block_reduce(c, SumI(), iscratch);
    if ((float)count > target) lo = mid; else hi = mid;
  }
  const float t = __fmul_rn(0.5f, __fadd_rn(lo, hi));

  int c = 0;
  double s = 0.0;
  for (int i = threadIdx.x; i < SEG; i += THREADS) {
    const float a = fabsf(seg[i]);
    if (a > t) { ++c; s += (double)a; }
  }
  const int cnt = block_reduce(c, SumI(), iscratch);
  const double sum = block_reduce(s, SumD(), dscratch);
  const float mu = __double2float_rn(sum / fmax((double)cnt, 1.0));

  for (int i = threadIdx.x; i < real; i += THREADS) {
    const float v = seg[i];
    outr[i] = fabsf(v) > t ? copysignf(mu, v) : 0.0f;
  }
  if (threadIdx.x == 0 && cnt) atomicAdd(nnz + row, cnt);
}

}  // namespace

extern "C" int stc_batched_launch(const float* x, float* out, int* nnz,
                                  int64_t N, int64_t D, float keep_frac,
                                  void* stream) {
  if (N <= 0 || D <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(nnz, 0, sizeof(int) * N, s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((D + SEG - 1) / SEG), (unsigned)N);
  stc_batched_kernel<<<grid, THREADS, 0, s>>>(x, out, nnz, D, keep_frac);
  return (int)cudaGetLastError();
}
