// Int8 quantization kernels for Hopper: the batched round trip with one
// scale per client row (K3), and the dense tiled quantize / dequantize pair
// (K5).
//
// K3 replaces the two TPU kernels of src/repro/kernels/quant.py that
// int8_roundtrip_batched chains (pallas_calls in _int8_roundtrip_padded):
//   * _rowmax_kernel: per-row max |x| accumulated across D-tiles;
//   * _qdq_kernel:    clip(round(x / s), -127, 127) * s with the per-row
//                     scale s = max(m, 1e-12) * f32(1/127), computed between
//                     the two launches by the caller.
// K5 replaces _quant_kernel (pallas_call in quantize) and _dequant_kernel
// (pallas_call in dequantize): per 8192-element tile of the flattened,
// zero-padded tensor, s = max(max|x|, 1e-12) / 127 as a true IEEE division,
// q = clip(rint(x / s), -127, 127) as int8; and back, q * s without the
// padding.
//
// Bound on the H100: memory.  The row max reads the (N, D) matrix once
// (4 bytes per element); the round trip reads it once more and writes the
// result (8 bytes per element); quantize reads 4 bytes and writes 1 per
// element, dequantize the reverse.  Each is a handful of operations per
// element, well below the card's ridge.
//
// Design.  Row max: a 2-D grid (column chunks x rows); each CTA reduces its
// chunk with warp shuffles and publishes it with one atomicMax on the
// float's bit pattern, which orders like the float because |x| >= 0 (NaN,
// as in the reference, wins).  Max is order-free, so the result equals the
// reference bit for bit.  Round trip: elementwise over the same grid, with
// an IEEE-rounded division (__fdiv_rn; the build never uses fast math),
// round-half-even (rintf), a clamp that lets NaN through like the
// reference's clip, and a separately rounded multiply, so every element
// equals the reference bit for bit.  Quantize: one CTA per 8192-element
// tile (the TPU's (8, 1024) block), a block max over the float bit
// patterns, then the same division, rounding and clamp; the padded tail of
// the last tile reads as 0 and writes q = 0, as the reference's zero pad
// does.  Dequantize: elementwise over the real elements only.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;  // elements per thread per CTA
constexpr int64_t CHUNK = (int64_t)THREADS * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
rowmax_kernel(const float* __restrict__ x, float* __restrict__ m, int64_t D) {
  __shared__ int scratch[WARPS];
  const int64_t row = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * CHUNK;
  const float* xr = x + row * D;
  int v = 0;  // bit pattern of max |x| (non-negative floats order as ints)
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t d = start + (int64_t)k * THREADS + threadIdx.x;
    if (d < D) v = max(v, __float_as_int(fabsf(__ldg(xr + d))));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = scratch[0];
#pragma unroll
    for (int i = 1; i < WARPS; ++i) r = max(r, scratch[i]);
    atomicMax(reinterpret_cast<int*>(m + row), r);
  }
}

__global__ void __launch_bounds__(THREADS)
qdq_kernel(const float* __restrict__ x, const float* __restrict__ scale,
           float* __restrict__ out, int64_t D) {
  const int64_t row = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * CHUNK;
  const float s = __ldg(scale + row);
  const float* xr = x + row * D;
  float* outr = out + row * D;
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t d = start + (int64_t)k * THREADS + threadIdx.x;
    if (d < D) {
      float q = rintf(__fdiv_rn(__ldg(xr + d), s));
      q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);  // NaN passes
      outr[d] = __fmul_rn(q, s);
    }
  }
}

constexpr int TILE = 8192;      // elements per K5 tile (8 x 1024)

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int64_t n) {
  __shared__ int scratch[WARPS];
  const int64_t start = (int64_t)blockIdx.x * TILE;
  const int real = (int)((n - start) < TILE ? (n - start) : TILE);
  const float* xt = x + start;
  int v = 0;  // bit pattern of max |x| (non-negative floats order as ints)
  for (int i = threadIdx.x; i < real; i += THREADS)
    v = max(v, __float_as_int(fabsf(__ldg(xt + i))));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = scratch[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) r = max(r, scratch[i]);
  const float m = __int_as_float(r);
  // max(m, 1e-12) with NaN propagating, as jnp.maximum does
  const float s = __fdiv_rn((m >= 1e-12f || m != m) ? m : 1e-12f, 127.0f);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
  int8_t* qt = q + start;
  for (int i = threadIdx.x; i < TILE; i += THREADS) {
    float qv = 0.0f;
    if (i < real) {
      qv = rintf(__fdiv_rn(__ldg(xt + i), s));
      qv = qv < -127.0f ? -127.0f : (qv > 127.0f ? 127.0f : qv);
    }
    qt[i] = (int8_t)qv;
  }
}

__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = __fmul_rn((float)__ldg(q + i), __ldg(scale + i / TILE));
}

dim3 grid_for(int64_t N, int64_t D) {
  return dim3((unsigned)((D + CHUNK - 1) / CHUNK), (unsigned)N);
}

}  // namespace

extern "C" int int8_rowmax_launch(const float* x, float* m, int64_t N,
                                  int64_t D, void* stream) {
  if (N <= 0 || D <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(m, 0, sizeof(float) * N, s);  // +0.0f
  if (err != cudaSuccess) return (int)err;
  rowmax_kernel<<<grid_for(N, D), THREADS, 0, s>>>(x, m, D);
  return (int)cudaGetLastError();
}

extern "C" int int8_qdq_launch(const float* x, const float* scale, float* out,
                               int64_t N, int64_t D, void* stream) {
  if (N <= 0 || D <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  qdq_kernel<<<grid_for(N, D), THREADS, 0, s>>>(x, scale, out, D);
  return (int)cudaGetLastError();
}

extern "C" int int8_quantize_launch(const float* x, int8_t* q, float* scale,
                                    int64_t n, void* stream) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  if (n <= 0 || tiles > 2147483647) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<(unsigned)tiles, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, q, scale, n);
  return (int)cudaGetLastError();
}

extern "C" int int8_dequantize_launch(const int8_t* q, const float* scale,
                                      float* out, int64_t n, void* stream) {
  const int64_t blocks = (n + THREADS - 1) / THREADS;
  if (n <= 0 || blocks > 2147483647) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)blocks, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(q, scale, out, n);
  return (int)cudaGetLastError();
}
