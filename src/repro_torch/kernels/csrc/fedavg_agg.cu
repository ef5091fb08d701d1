// FedAvg streaming weighted sum for Hopper: out[d] = sum_n w[n] * U[n, d].
//
// Replaces the TPU kernel src/repro/kernels/fedavg_agg.py::_agg_kernel
// (pallas_call in _aggregate_padded), which walks a 2-D grid of
// (D-tiles x client-chunks) and accumulates each D-tile in VMEM across the
// sequential client-chunk axis, and its hierarchical route
// (fedavg_aggregate_tree: one _aggregate_padded per group of a tier, under
// lax.map).
//
// Grouped form: out[g, d] = sum_f w[g*F + f] * U[g*F + f, d] for G groups
// of F consecutive rows.  gridDim.y = G, so one launch reduces every group
// of a tree tier; the flat sum is the case G = 1, F = N.
//
// Bound on the H100: memory.  Every element of the (N, D) f32 update matrix
// is read exactly once and used in one multiply-add, so the kernel moves
// 4*N*D + 4*D bytes for 2*N*D flops (0.5 flop/byte, far below the card's
// ~20 flop/byte fp32 ridge).  At N=16, D=6,603,710 that is 423 MB, about
// 126 us at 3.35 TB/s.  A grouped launch moves 4*G*F*D + 4*G*D bytes.
//
// Design: a grid of column chunks (x) by groups (y).  Each thread owns COLS
// columns of its group and loops over the group's rows, keeping the running sums in fp32 registers: the
// GPU form of Pallas's revisit-accumulate over the client axis, with no
// atomics and a fixed summation order (n = 0 .. N-1), so results are
// deterministic and equal bit for bit to the plain PyTorch version, which
// accumulates in the same order.  The multiply and the add are rounded
// separately (__fmul_rn / __fadd_rn) for that reason.  When D is a multiple
// of 4 and the buffers are 16-byte aligned each thread loads its 4
// contiguous columns as one float4; otherwise neighbouring threads read
// neighbouring scalars (still coalesced).  The ragged D edge is masked in
// the kernel; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 4;  // columns per thread

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
fedavg_agg_kernel(const float* __restrict__ U, const float* __restrict__ w,
                  float* __restrict__ out, int64_t F, int64_t D) {
  // block row g = blockIdx.y reduces rows g*F .. g*F+F-1 into out[g, :]
  const int64_t g = blockIdx.y;
  U += g * F * D;
  w += g * F;
  out += g * D;
  float acc[COLS];
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc[k] = 0.0f;

  if (VEC) {
    // thread owns columns d0 .. d0+3 (D % 4 == 0, so all four are in range)
    const int64_t d0 =
        ((int64_t)blockIdx.x * THREADS + threadIdx.x) * COLS;
    if (d0 >= D) return;
    for (int64_t n = 0; n < F; ++n) {
      const float wn = __ldg(w + n);
      const float4 u = __ldg(reinterpret_cast<const float4*>(U + n * D + d0));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wn, u.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(wn, u.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(wn, u.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(wn, u.w));
    }
    *reinterpret_cast<float4*>(out + d0) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    // thread owns columns base, base+THREADS, ... (coalesced scalar loads)
    const int64_t base = (int64_t)blockIdx.x * THREADS * COLS + threadIdx.x;
    for (int64_t n = 0; n < F; ++n) {
      const float wn = __ldg(w + n);
      const float* row = U + n * D;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int64_t d = base + (int64_t)k * THREADS;
        if (d < D) acc[k] = __fadd_rn(acc[k], __fmul_rn(wn, __ldg(row + d)));
      }
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int64_t d = base + (int64_t)k * THREADS;
      if (d < D) out[d] = acc[k];
    }
  }
}

}  // namespace

// U is (G*F, D), w (G*F,), out (G, D), all contiguous f32.
extern "C" int fedavg_agg_grouped_launch(const float* U, const float* w,
                                         float* out, int64_t G, int64_t F,
                                         int64_t D, void* stream) {
  if (G <= 0 || G > 65535 || F <= 0 || D <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t per_block = (int64_t)THREADS * COLS;
  const dim3 grid((unsigned)((D + per_block - 1) / per_block), (unsigned)G);
  // every group's rows and output start 16-byte aligned when D % 4 == 0
  const bool aligned = (D % 4 == 0) &&
                       (reinterpret_cast<uintptr_t>(U) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (aligned) {
    fedavg_agg_kernel<true><<<grid, THREADS, 0, s>>>(U, w, out, F, D);
  } else {
    fedavg_agg_kernel<false><<<grid, THREADS, 0, s>>>(U, w, out, F, D);
  }
  return (int)cudaGetLastError();
}

// The flat weighted sum: one group of all N rows.
extern "C" int fedavg_agg_launch(const float* U, const float* w, float* out,
                                 int64_t N, int64_t D, void* stream) {
  return fedavg_agg_grouped_launch(U, w, out, 1, N, D, stream);
}
