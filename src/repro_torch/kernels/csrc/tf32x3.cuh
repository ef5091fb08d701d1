// Helpers shared by the tensor-core kernels (flash_attn.cu, wkv6.cu):
// cp.async copies into shared memory, and fp32-accurate products on
// mma.sync.m16n8k8 TF32 in 3xTF32.
//
// Precision ("TF32 off" semantics).  Every operand x of a product is split in
// registers into big = x rounded to TF32 (to nearest, ties away) and small =
// x - big (exact in fp32), which the MMA truncates to TF32, and a.b is taken
// as small_a.big_b + big_a.small_b + big_a.big_b — the 3xTF32 scheme of
// CUTLASS's OpMultiplyAddFastF32 (which rounds big toward zero and small to
// nearest instead; both cost three instructions, and this way round the
// dropped small.small term is <= 2^-22 of |a.b|).  The tensor core's fp32
// accumulation does not round to nearest, and its error grows with the
// number of MMAs into one accumulator, so callers keep the small terms in
// an accumulator of their own, and sums that run over many tiles in zeroed
// register blocks added in fp32.
//
// Fragments of mma.sync.m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product sums over the k index, so a kernel may relabel it: A holding
// physical columns (2t, 2t + 1) as logical (t, t + 4) pairs with B rows 2t
// and 2t + 1.  That is how a C fragment becomes the next product's A
// fragment without shared memory (mma_cols).
//
// Shared-memory tiles have rows of DP + 4 floats: 16-byte aligned for
// cp.async, and the 8 rows g of a fragment load fall on distinct banks.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------
// x = big + small for a 3xTF32 product.  big rounds x to TF32 to nearest
// (ties away) by adding half a TF32 ulp to the bit pattern: the MMA reads
// only the 19 high bits of an operand, so the sum is the operand, and its
// value with the 13 low bits cleared is subtracted from x, exactly; small,
// that remainder, is truncated to TF32 by the MMA.  Three instructions and
// no branch (cvt.rna.tf32.f32 takes three or four, with a predicated branch
// for non-finite x, on each of the two parts); a NaN x leaves small NaN, so
// NaNs propagate.
template <int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    big[i] = __float_as_uint(x[i]) + 0x1000u;
    small[i] = __float_as_uint(x[i] - __uint_as_float(big[i] & 0xffffe000u));
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of acc[nb] += A . B[nb] for nb < NB, B already split: the two
// small terms go to lo, big . big to acc, each pass over all n-blocks in
// turn so NB independent MMAs separate two on one accumulator.
template <int NB>
__device__ __forceinline__ void mma3_split(float (&acc)[NB][4],
                                           float (&lo)[NB][4],
                                           const float (&a)[4],
                                           const uint32_t (&bb)[NB][2],
                                           const uint32_t (&bs)[NB][2]) {
  uint32_t ab[4], as[4];
  split(a, ab, as);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) mma(lo[nb], as, bb[nb]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) mma(lo[nb], ab, bs[nb]);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) mma(acc[nb], ab, bb[nb]);
}

// the same from fp32 B fragments
template <int NB>
__device__ __forceinline__ void mma3(float (&acc)[NB][4], float (&lo)[NB][4],
                                     const float (&a)[4],
                                     const float (&b)[NB][2]) {
  uint32_t bb[NB][2], bs[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) split(b[nb], bb[nb], bs[nb]);
  mma3_split<NB>(acc, lo, a, bb, bs);
}

// acc[nd] += C . B over the score tile's columns: C is the warp's 16 x 8 NB
// score tile in C-fragment form, taken as the A fragment (c0, c2, c1, c3)
// with the summed index relabelled (logical t <-> column 2t, t + 4 <->
// 2t + 1), so B reads rows 8 kb + 2t and 8 kb + 2t + 1 of the (rows, DP)
// tile Bs.  Head-dim blocks go in groups of G, three passes over each group.
// FRESH: a group sums this tile's products in a zeroed register block and
// adds it to acc in fp32, so no tensor-core accumulation chain spans more
// than one tile (the backward, whose sums run over up to S / 32 tiles);
// else the MMAs accumulate into acc itself (the forward, where the
// registers for the block would cost a CTA per SM).  LD is Bs's row
// stride: DP + 4 for a whole tile, wider when acc takes a column block of
// DP columns from a tile of more (flash_attn.cu at head dims above 128).
template <int DP, int NB, int G, bool FRESH, int LD = DP + 4>
__device__ __forceinline__ void mma_cols(float (&acc)[DP / 8][4],
                                         const float (&c)[NB][4],
                                         const float* Bs, int g, int t) {
  constexpr int ND = DP / 8, GN = ND < G ? ND : G;
  static_assert(ND % GN == 0, "head-dim blocks must fill whole groups");
#pragma unroll
  for (int n0 = 0; n0 < ND; n0 += GN) {
    float sum[GN][4];
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[j][e] = FRESH ? 0.0f : acc[n0 + j][e];
#pragma unroll
    for (int kb = 0; kb < NB; ++kb) {
      const float a[4] = {c[kb][0], c[kb][2], c[kb][1], c[kb][3]};
      uint32_t ab[4], as[4];
      split(a, ab, as);
      const float* b0 = Bs + (8 * kb + 2 * t) * LD + g;
      uint32_t bb[GN][2], bs[GN][2];
#pragma unroll
      for (int j = 0; j < GN; ++j) {
        const float b[2] = {b0[8 * (n0 + j)], b0[LD + 8 * (n0 + j)]};
        split(b, bb[j], bs[j]);
      }
#pragma unroll
      for (int j = 0; j < GN; ++j) mma(sum[j], as, bb[j]);
#pragma unroll
      for (int j = 0; j < GN; ++j) mma(sum[j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < GN; ++j) mma(sum[j], ab, bb[j]);
    }
#pragma unroll
    for (int j = 0; j < GN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + j][e] = FRESH ? acc[n0 + j][e] + sum[j][e] : sum[j][e];
  }
}

// allow `fn` its dynamic shared memory and the largest carveout
inline cudaError_t prepare(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// out[4] = registers, local (spill) bytes, dynamic shared memory bytes and
// resident CTAs per SM of `fn` launched with `threads` threads and `smem`
// bytes, as the runtime reads them
inline int kernel_resources(const void* fn, int threads, size_t smem,
                            int* out) {
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = attr.maxDynamicSharedSizeBytes;
  out[3] = ctas;
  return 0;
}

}  // namespace
