// Int8 quantization kernels for Hopper: the batched round trip with one
// scale per client row (K3), and the dense tiled quantize / dequantize pair
// (K5).
//
// K3 replaces the two TPU kernels of src/repro/kernels/quant.py that
// int8_roundtrip_batched chains (pallas_calls in _int8_roundtrip_padded):
//   * _rowmax_kernel: per-row max |x| accumulated across D-tiles;
//   * _qdq_kernel:    clip(round(x / s), -127, 127) * s with the per-row
//                     scale s = max(m, 1e-12) * f32(1/127), computed between
//                     the two launches by the caller.  On request it also
//                     writes the int8 q itself (the sequential compression
//                     stage sends q and s, core/compression.py).
// K5 replaces _quant_kernel (pallas_call in quantize) and _dequant_kernel
// (pallas_call in dequantize): per 8192-element tile of the flattened,
// zero-padded tensor, s = max(max|x|, 1e-12) / 127 as a true IEEE division,
// q = clip(rint(x / s), -127, 127) as int8; and back, q * s without the
// padding.  Quantize reads f32, bf16 or f16 and widens to f32 in the kernel,
// as _quant_kernel's astype does.
//
// Bound on the H100: memory.  The row max reads the (N, D) matrix once
// (4 bytes per element); the round trip reads it once more and writes the
// result (8 bytes per element, 9 with q); quantize reads 4 bytes and writes 1 per
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
// equals the reference bit for bit.
//
// K5 moves 5 bytes an element and, at the 2^20 elements of the compression
// API path, 128 tiles: one wave on 132 SMs, so latency and bytes in flight
// set its time.  Both kernels access memory by one plan a tile (TilePlan,
// mirrored by kernels/quant.py::tile_plan): 16-byte vectors from the tile's
// first 16-byte-aligned element on, scalar accesses for the head before it
// and the tail after the last whole vector, so any pointer a contiguous
// tensor may have works and no vector crosses a tile or reads past n.
// Quantize: one CTA a tile.  Every thread issues all its 16-byte loads (the
// whole 32 KB f32 tile is in flight at once) and keeps the tile in
// registers; the max goes through warp reductions (redux.sync) and one
// shared-memory step;
// q comes from the registers (x is read once) with the same division and
// rounding as the round trip (qbyte), into shared memory at each
// element's place, and leaves in 16-byte stores, the padding as q = 0.
// Dequantize: a thread a 16-element vector, one 16-byte load of q and one
// load of the tile's scale (16 divides 8192, so a vector has one scale),
// a separately rounded multiply, four 16-byte stores after a shuffle
// transpose within the warp, so that each store instruction is coalesced.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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
           float* __restrict__ out, int8_t* __restrict__ qout, int64_t D) {
  const int64_t row = blockIdx.y;
  const int64_t start = (int64_t)blockIdx.x * CHUNK;
  const float s = __ldg(scale + row);
  const float* xr = x + row * D;
  float* outr = out + row * D;
  int8_t* qr = qout ? qout + row * D : nullptr;
#pragma unroll 4
  for (int k = 0; k < PER_THREAD; ++k) {
    const int64_t d = start + (int64_t)k * THREADS + threadIdx.x;
    if (d < D) {
      float q = rintf(__fdiv_rn(__ldg(xr + d), s));
      q = q < -127.0f ? -127.0f : (q > 127.0f ? 127.0f : q);  // NaN passes
      outr[d] = __fmul_rn(q, s);
      // q is integral in [-127, 127] (NaN converts to 0)
      if (qr) qr[d] = (int8_t)__float2int_rn(q);
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dense tiled quantize / dequantize
// ---------------------------------------------------------------------------

constexpr int TILE = 8192;      // elements per K5 tile (8 x 1024)
// quantize threads per CTA: in a sweep on the H100, 512 beat 256 and was
// level with 1024 (PERF.md)
constexpr int Q_THREADS = 512;
constexpr int DQ_THREADS = 256;  // dequantize threads per CTA
constexpr int DQ_VEC = 16;       // int8 elements per 16-byte dequantize load

// The accesses of one tile (kernels/quant.py::tile_plan is the same
// arithmetic, which the CPU tests hold to its rules).  `head` is the number
// of elements from a tile's start to its first 16-byte-aligned element: the
// same in every tile, since a tile's bytes are a multiple of 16.  Of a
// tile's `real` elements, nvec vectors of `vec` elements cover [lead, tail),
// and nscal scalar accesses cover [0, lead) and [tail, real).
struct TilePlan {
  int lead, nvec, tail, nscal;
  __device__ TilePlan(int real, int head, int vec)
      : lead(min(head, real)), nvec((real - min(head, real)) / vec),
        tail(lead + vec * nvec), nscal(lead + real - tail) {}
  // the element that scalar access i covers
  __device__ int scalar(int i) const { return i < lead ? i : tail + i - lead; }
};

template <typename T> struct Widen;  // a 16-bit pattern to its exact f32
template <> struct Widen<__nv_bfloat16> {
  __device__ static float of(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
};
template <> struct Widen<__half> {
  __device__ static float of(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
};

template <typename T>
__device__ __forceinline__ float load_one(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(reinterpret_cast<const float*>(p));
  } else {
    return Widen<T>::of(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// 16 / sizeof(T) elements from one 16-byte load at a 16-byte-aligned p
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(u[i]);
    } else {
      v[2 * i] = Widen<T>::of((unsigned short)(u[i] & 0xffffu));
      v[2 * i + 1] = Widen<T>::of((unsigned short)(u[i] >> 16));
    }
  }
}

// q of one element of a tile with scale s as its byte: IEEE division, round
// half to even, the int8 conversion.  clip(., -127, 127) is the identity
// here, so the kernel leaves its compares out (tests/test_torch_kernels.py::
// test_k5_clip_never_binds_for_any_tile_max checks every mantissa): for
// finite s = RN(m' / 127) with m' >= max |x|, |x / s| <= m' / s <=
// 127 / (1 - 2^-24) < 127.5, so |rint(x / s)| <= 127; for s NaN or inf the
// only quotient out of range is NaN, which the clip passes through.
__device__ __forceinline__ uint32_t qbyte(float x, float s) {
  return (uint8_t)(int8_t)rintf(__fdiv_rn(x, s));
}

template <typename T, int NT>
__global__ void __launch_bounds__(NT)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale, int64_t n, int head) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int SLOTS = TILE / VEC / NT;  // 16-byte loads a thread
  static_assert(SLOTS >= 1 && SLOTS * VEC * NT == TILE, "tile split");
  __shared__ int wmax[NT / 32];
  __shared__ __align__(16) uint8_t qs[TILE];
  const int tid = threadIdx.x;
  const int64_t start = (int64_t)blockIdx.x * TILE;
  const int real = (int)min((int64_t)TILE, n - start);
  const TilePlan plan(real, head, VEC);
  const T* xt = x + start;

  // every load in flight before any arithmetic: SLOTS vectors (vector
  // j = k * NT + tid: a warp's load covers 512 contiguous bytes) and at most
  // one scalar
  float v[SLOTS][VEC];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int j = k * NT + tid;
    if (j < plan.nvec) {
      load_vec(xt + plan.lead + VEC * j, v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[k][e] = 0.0f;
    }
  }
  const float xs = tid < plan.nscal ? load_one(xt + plan.scalar(tid)) : 0.0f;

  // max |x| over the float bit patterns (non-negative floats order as ints;
  // NaN wins)
  int m = __float_as_int(fabsf(xs));
#pragma unroll
  for (int k = 0; k < SLOTS; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) m = max(m, __float_as_int(fabsf(v[k][e])));
  m = __reduce_max_sync(0xffffffffu, m);
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  m = __reduce_max_sync(0xffffffffu, (tid & 31) < NT / 32 ? wmax[tid & 31] : 0);
  const float mf = __int_as_float(m);
  // max(m, 1e-12) with NaN propagating, as jnp.maximum does
  const float s = __fdiv_rn((mf >= 1e-12f || mf != mf) ? mf : 1e-12f, 127.0f);
  if (tid == 0) scale[blockIdx.x] = s;

  // q into shared memory at each element's place in the tile: words where
  // the vectors start word-aligned, bytes where they do not ...
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int j = k * NT + tid;
    if (j >= plan.nvec) continue;
    uint32_t w[VEC / 4];
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      w[i] = qbyte(v[k][4 * i], s) | qbyte(v[k][4 * i + 1], s) << 8 |
             qbyte(v[k][4 * i + 2], s) << 16 | qbyte(v[k][4 * i + 3], s) << 24;
    uint8_t* dst = qs + plan.lead + VEC * j;
    if ((plan.lead & 3) == 0) {
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
    } else {
#pragma unroll
      for (int b = 0; b < VEC; ++b) dst[b] = (uint8_t)(w[b / 4] >> (8 * (b % 4)));
    }
  }
  if (tid < plan.nscal) qs[plan.scalar(tid)] = (uint8_t)qbyte(xs, s);
  __syncthreads();
  // ... then out in 16-byte stores, neighbouring threads on neighbouring
  // addresses, the tile's padding (>= real) as q = 0
  for (int c = tid; c < TILE / 16; c += NT) {
    uint4 w = reinterpret_cast<const uint4*>(qs)[c];
    if (16 * c + 16 > real) {
      uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int keep = min(max(real - 16 * c - 4 * i, 0), 4);  // real bytes
        if (keep < 4) u[i] &= (1u << (8 * keep)) - 1u;
      }
      w = make_uint4(u[0], u[1], u[2], u[3]);
    }
    reinterpret_cast<uint4*>(q + start)[c] = w;
  }
}

// Thread j of the CTAs of a tile: its vector (and scalar access) j, on a
// grid of exactly one thread a slot (a grid-stride loop over fewer CTAs
// measured slower; PERF.md).  A warp holds 32 consecutive vectors of one
// tile (32 divides 512): each thread loads its vector's 16 q bytes in one
// 16-byte load, and the warp passes the words round with shuffles so that
// each of its four float4 stores covers 512 contiguous bytes.  The scale's
// load is written first: written where it is used, it was issued after the
// shuffles, which wait for q, so the two loads' latencies ran in series
// (PERF.md).
__global__ void __launch_bounds__(DQ_THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                  float* __restrict__ out, int64_t n, int head) {
  constexpr int PER_TILE = TILE / DQ_VEC;
  static_assert(PER_TILE % DQ_THREADS == 0, "a CTA inside one tile");
  const int lane = threadIdx.x & 31;
  constexpr int CTAS_PER_TILE = PER_TILE / DQ_THREADS;
  const int tile = blockIdx.x / CTAS_PER_TILE;
  const float s = __ldg(scale + tile);
  const int j = (blockIdx.x % CTAS_PER_TILE) * DQ_THREADS + threadIdx.x;
  const int64_t start = (int64_t)tile * TILE;
  const TilePlan plan((int)min((int64_t)TILE, n - start), head, DQ_VEC);
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (j < plan.nvec)
    w = __ldg(reinterpret_cast<const uint4*>(q + start + plan.lead + DQ_VEC * j));
  // float4 f (0..127) of the warp's 512 elements is word f % 4 of the
  // vector of lane f / 4
  const int j0 = j - lane;
  float* o = out + start + plan.lead + DQ_VEC * j0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int src = 8 * i + (lane >> 2);
    const uint32_t w0 = __shfl_sync(0xffffffffu, w.x, src);
    const uint32_t w1 = __shfl_sync(0xffffffffu, w.y, src);
    const uint32_t w2 = __shfl_sync(0xffffffffu, w.z, src);
    const uint32_t w3 = __shfl_sync(0xffffffffu, w.w, src);
    const uint32_t word = lane & 2 ? (lane & 1 ? w3 : w2) : (lane & 1 ? w1 : w0);
    if (j0 + src >= plan.nvec) continue;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) f[b] = __fmul_rn((float)(int8_t)(word >> (8 * b)), s);
    float* e = o + 4 * (32 * i + lane);
    if ((plan.lead & 3) == 0) {  // e is 16-byte aligned
      *reinterpret_cast<float4*>(e) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) e[b] = f[b];
    }
  }
  if (j < plan.nscal) {
    const int p = plan.scalar(j);
    out[start + p] = __fmul_rn((float)__ldg(q + start + p), s);
  }
}

template <typename T>
int quantize_as(const void* x, int8_t* q, float* scale, int64_t n, int head,
                int64_t tiles, cudaStream_t s) {
  if (head < 0 || head >= (int)(16 / sizeof(T)) ||
      ((uintptr_t)x + head * sizeof(T)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  quantize_kernel<T, Q_THREADS><<<(unsigned)tiles, Q_THREADS, 0, s>>>(
      static_cast<const T*>(x), q, scale, n, head);
  return (int)cudaGetLastError();
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

// q: an (N, D) int8 output for round(x / s) clamped, or NULL (the batched
// round trip needs only q * s).
extern "C" int int8_qdq_launch(const float* x, const float* scale, float* out,
                               int8_t* q, int64_t N, int64_t D, void* stream) {
  if (N <= 0 || D <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  qdq_kernel<<<grid_for(N, D), THREADS, 0, s>>>(x, scale, out, q, D);
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16, 2 float16.  head: elements from a tile's
// start to its first 16-byte-aligned element (kernels/quant.py::
// vector_head).  q must be 16-byte aligned.
extern "C" int int8_quantize_launch(const void* x, int8_t* q, float* scale,
                                    int64_t n, int dtype, int head,
                                    void* stream) {
  const int64_t tiles = (n + TILE - 1) / TILE;
  if (n <= 0 || tiles > 2147483647 || (uintptr_t)q % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return quantize_as<float>(x, q, scale, n, head, tiles, s);
    case 1: return quantize_as<__nv_bfloat16>(x, q, scale, n, head, tiles, s);
    case 2: return quantize_as<__half>(x, q, scale, n, head, tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// head: as for quantize, of q.  out must be 16-byte aligned.
extern "C" int int8_dequantize_launch(const int8_t* q, const float* scale,
                                      float* out, int64_t n, int head,
                                      void* stream) {
  const int64_t blocks = (n + TILE - 1) / TILE * (TILE / DQ_VEC / DQ_THREADS);
  if (n <= 0 || head < 0 || head >= DQ_VEC || ((uintptr_t)q + head) % 16 != 0 ||
      (uintptr_t)out % 16 != 0 || blocks > 2147483647)
    return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<(unsigned)blocks, DQ_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(q, scale, out, n,
                                                           head);
  return (int)cudaGetLastError();
}

// out[4] = registers, local (spill) bytes, static shared memory bytes and
// resident CTAs per SM, as the runtime reads them, of kernel 0 (quantize,
// f32) or 1 (dequantize)
extern "C" int int8_kernel_info(int kernel, int* out) {
  const void* fn = kernel == 0 ? (const void*)quantize_kernel<float, Q_THREADS>
                   : kernel == 1 ? (const void*)dequantize_kernel
                                 : nullptr;
  const int threads = kernel == 0 ? Q_THREADS : DQ_THREADS;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, fn, threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = ctas;
  return 0;
}
