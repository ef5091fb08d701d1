// Flash attention for Hopper in fp32: the online-softmax forward and the
// two recompute-from-LSE backward kernels, over (BH, S, D) MHA-layout
// tensors (row-major, contiguous), causal or not, any S, D <= 128.
//
// Replaces the three TPU kernels of src/repro/kernels/attention.py:
//   * _fwd_kernel (pallas_call in _fwd_padded)  -> flash_fwd_kernel
//   * _dq_kernel  (pallas_call in _bwd_padded)  -> flash_dq_kernel
//   * _dkv_kernel (pallas_call in _bwd_padded)  -> flash_dkv_kernel
// with the reference's semantics: scores = (q . k) * scale with scale =
// 1/sqrt(real D) passed in by the caller, validity from *global* indices
// against the real S (key j visible to query i iff j < S and, causal, j <=
// i), masked scores = NEG_INF = -1e30 (not -inf), the denominator floored at
// 1e-30, LSE = m + log(l), and in the backward P = exp(s - LSE),
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O) computed by the
// caller.
//
// Bound on the H100: operations.  Each (query, key) pair costs 4D flops in
// the forward, 6D in dq and 8D in dk/dv, against 4-5 bytes per element of
// input and output per tile row: at D = 128 and S = 512 that is far above
// the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flop/byte).  These
// kernels use plain fp32 FMAs on the CUDA cores (no TF32, no tensor cores),
// so the fp32 peak is their roofline.
//
// Design.  On the TPU the key-tile axis is a sequential grid dimension that
// revisits one VMEM output block; here that axis becomes a loop inside one
// CTA, and CTAs run in parallel over (bh, tile):
//   * one CTA of 256 threads per (bh, 64-row tile); the thread (ty, tx) of
//     the 16 x 16 layout owns rows ty + 16 i and columns tx + 16 j (i, j < 4)
//     of every 64 x 64 score tile — interleaved, so a warp's shared-memory
//     reads of K / V rows hit distinct banks (row stride D_pad + 1) — and
//     columns tx + 16 jd of the 64 x D_pad output tile in registers;
//   * tiles are staged in dynamic shared memory (above 48 KB, hence
//     cudaFuncSetAttribute), zero-filled beyond S and D, so a ragged tail
//     needs no padded copy in device memory;
//   * row statistics (max, sum) reduce over the 16 lanes of a half-warp
//     with shuffles; the probability or dS tile goes through shared memory
//     for the second product;
//   * causal CTAs stop (forward, dq) or start (dk/dv) at the diagonal tile;
//   * dk/dv loop over query tiles inside one CTA per key tile, so every
//     output element has one writer: no atomics, deterministic results.
// A simple, correct first version: no wgmma, no TMA, no pipelining.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // query and key tile rows (reference TILE_Q/K)
constexpr int THREADS = 256;  // 16 x 16
constexpr int PT = TILE + 1;  // row stride of a 64 x 64 tile in shared memory
constexpr float NEG_INF = -1e30f;
constexpr float TINY = 1e-30f;

// rows [row0, row0 + 64) and columns [0, 16 NDV) of one (S, D) matrix into
// shared memory (row stride 16 NDV + 1), zeros beyond S and D
template <int NDV>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int D) {
  constexpr int DP = 16 * NDV, LD = DP + 1;
  for (int idx = threadIdx.x; idx < TILE * DP; idx += THREADS) {
    const int r = idx / DP, d = idx - r * DP;
    const int g = row0 + r;
    dst[r * LD + d] = (g < S && d < D) ? __ldg(src + (int64_t)g * D + d)
                                       : 0.0f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}

// ---------------------------------------------------------------------------
// K6: forward.  grid (BH, ceil(S / 64)); O (BH, S, D), LSE (BH, S)
// ---------------------------------------------------------------------------
template <int NDV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int D, float scale,
                 int causal) {
  constexpr int DP = 16 * NDV, LD = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ps = Vs + TILE * LD;  // TILE x PT probabilities
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<NDV>(Qs, q + off, q0, S, D);

  float m[4], l[4], acc[4][NDV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) acc[i][jd] = 0.0f;
  }
  const int nk = (S + TILE - 1) / TILE;
  const int kend = causal ? min(qt + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();  // every reader of the previous K / V / P tile is done
    load_tile<NDV>(Ks, k + off, kt * TILE, S, D);
    load_tile<NDV>(Vs, v + off, kt * TILE, S, D);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(qi, kt * TILE + tx + 16 * j, S, causal);
        s[i][j] *= scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        Ps[(ty + 16 * i) * PT + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < NDV; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[4], vv[NDV];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PT + c];
#pragma unroll
      for (int jd = 0; jd < NDV; ++jd) vv[jd] = Vs[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < NDV; ++jd)
          acc[i][jd] = fmaf(p[i], vv[jd], acc[i][jd]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
    const float li = fmaxf(l[i], TINY);
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) o[off + (int64_t)qi * D + d] = acc[i][jd] / li;
    }
    if (tx == 0) lse[bh * S + qi] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// K7a: dQ.  grid (BH, ceil(S / 64)), one CTA per query tile over key tiles
// ---------------------------------------------------------------------------
template <int NDV>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int S, int D, float scale, int causal) {
  constexpr int DP = 16 * NDV, LD = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + TILE * LD;
  float* Ss = Vs + TILE * LD;  // TILE x PT dS
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int qt = blockIdx.y, q0 = qt * TILE;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<NDV>(Qs, q + off, q0, S, D);
  load_tile<NDV>(Gs, dout + off, q0, S, D);

  float lr[4], dr[4], acc[4][NDV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    lr[i] = qi < S ? __ldg(lse + bh * S + qi) : 0.0f;
    dr[i] = qi < S ? __ldg(delta + bh * S + qi) : 0.0f;
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) acc[i][jd] = 0.0f;
  }
  const int nk = (S + TILE - 1) / TILE;
  const int kend = causal ? min(qt + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    __syncthreads();
    load_tile<NDV>(Ks, k + off, kt * TILE, S, D);
    load_tile<NDV>(Vs, v + off, kt * TILE, S, D);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      float a[4], g[4], b[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        g[i] = Gs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * LD + d];
        e[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qi, kt * TILE + tx + 16 * j, S, causal);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.0f;
        Ss[(ty + 16 * i) * PT + tx + 16 * j] = p * (dp[i][j] - dr[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float ds[4], kv[NDV];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(ty + 16 * i) * PT + c];
#pragma unroll
      for (int jd = 0; jd < NDV; ++jd) kv[jd] = Ks[c * LD + tx + 16 * jd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < NDV; ++jd)
          acc[i][jd] = fmaf(ds[i], kv[jd], acc[i][jd]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= S) continue;
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) dq[off + (int64_t)qi * D + d] = acc[i][jd];
    }
  }
}

// ---------------------------------------------------------------------------
// K7b: dK, dV.  grid (BH, ceil(S / 64)), one CTA per key tile over query
// tiles from the diagonal
// ---------------------------------------------------------------------------
template <int NDV>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int D, float scale,
                 int causal) {
  constexpr int DP = 16 * NDV, LD = DP + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ps = Gs + TILE * LD;  // TILE x PT, [query][key]
  float* Ss = Ps + TILE * PT;  // TILE x PT dS, [query][key]
  float* Ls = Ss + TILE * PT;  // LSE of the query tile
  float* Ds = Ls + TILE;       // delta of the query tile
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t bh = blockIdx.x;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<NDV>(Ks, k + off, k0, S, D);
  load_tile<NDV>(Vs, v + off, k0, S, D);

  float gk[4][NDV], gv[4][NDV];  // rows: keys ty + 16 i; cols tx + 16 jd
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) gk[i][jd] = gv[i][jd] = 0.0f;
  const int nq = (S + TILE - 1) / TILE;
  for (int qt = causal ? kt : 0; qt < nq; ++qt) {
    const int q0 = qt * TILE;
    __syncthreads();
    load_tile<NDV>(Qs, q + off, q0, S, D);
    load_tile<NDV>(Gs, dout + off, q0, S, D);
    if (threadIdx.x < TILE) {
      const int g = q0 + threadIdx.x;
      Ls[threadIdx.x] = g < S ? __ldg(lse + bh * S + g) : 0.0f;
      Ds[threadIdx.x] = g < S ? __ldg(delta + bh * S + g) : 0.0f;
    }
    __syncthreads();
    // score block: queries ty + 16 i, keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < DP; ++d) {
      float a[4], g[4], b[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        g[i] = Gs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * LD + d];
        e[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], e[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = visible(q0 + r, k0 + c, S, causal);
        const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.0f;
        Ps[r * PT + c] = p;
        Ss[r * PT + c] = p * (dp[i][j] - Ds[r]) * scale;
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's 64 queries
#pragma unroll 2
    for (int r = 0; r < TILE; ++r) {
      float pk[4], sk[4], gg[NDV], qq[NDV];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = Ps[r * PT + ty + 16 * i];
        sk[i] = Ss[r * PT + ty + 16 * i];
      }
#pragma unroll
      for (int jd = 0; jd < NDV; ++jd) {
        gg[jd] = Gs[r * LD + tx + 16 * jd];
        qq[jd] = Qs[r * LD + tx + 16 * jd];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jd = 0; jd < NDV; ++jd) {
          gv[i][jd] = fmaf(pk[i], gg[jd], gv[i][jd]);
          gk[i][jd] = fmaf(sk[i], qq[jd], gk[i][jd]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= S) continue;
#pragma unroll
    for (int jd = 0; jd < NDV; ++jd) {
      const int d = tx + 16 * jd;
      if (d < D) {
        dk[off + (int64_t)kj * D + d] = gk[i][jd];
        dv[off + (int64_t)kj * D + d] = gv[i][jd];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <int NDV>
constexpr size_t tile_floats() { return (size_t)TILE * (16 * NDV + 1); }

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_shape(int64_t BH, int64_t S, int64_t D) {
  return BH <= 0 || S <= 0 || D <= 0 || D > 128 || BH > 0x7fffffff ||
         S > 0x7fffffff || (S + TILE - 1) / TILE > 65535;
}

dim3 grid_for(int64_t BH, int64_t S) {
  return dim3((unsigned)BH, (unsigned)((S + TILE - 1) / TILE));
}

template <int NDV>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int64_t BH, int64_t S, int64_t D, float scale, int causal,
        cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * tile_floats<NDV>() + TILE * PT);
  cudaError_t err = prepare(flash_fwd_kernel<NDV>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<NDV><<<grid_for(BH, S), THREADS, smem, st>>>(
      q, k, v, o, lse, (int)S, (int)D, scale, causal);
  return (int)cudaGetLastError();
}

template <int NDV>
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dq_, int64_t BH,
       int64_t S, int64_t D, float scale, int causal, cudaStream_t st) {
  const size_t smem = sizeof(float) * (4 * tile_floats<NDV>() + TILE * PT);
  cudaError_t err = prepare(flash_dq_kernel<NDV>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<NDV><<<grid_for(BH, S), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dq_, (int)S, (int)D, scale, causal);
  return (int)cudaGetLastError();
}

template <int NDV>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dk, float* dv,
        int64_t BH, int64_t S, int64_t D, float scale, int causal,
        cudaStream_t st) {
  const size_t smem = sizeof(float) *
                      (4 * tile_floats<NDV>() + 2 * TILE * PT + 2 * TILE);
  cudaError_t err = prepare(flash_dkv_kernel<NDV>, smem);
  if (err != cudaSuccess) return (int)err;
  flash_dkv_kernel<NDV><<<grid_for(BH, S), THREADS, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, (int)S, (int)D, scale, causal);
  return (int)cudaGetLastError();
}

int ndv_for(int64_t D) {
  return D <= 16 ? 1 : D <= 32 ? 2 : D <= 64 ? 4 : 8;
}

}  // namespace

extern "C" int flash_fwd_launch(const float* q, const float* k,
                                const float* v, float* o, float* lse,
                                int64_t BH, int64_t S, int64_t D, float scale,
                                int causal, void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ndv_for(D)) {
    case 1: return fwd<1>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 2: return fwd<2>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 4: return fwd<4>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    default: return fwd<8>(q, k, v, o, lse, BH, S, D, scale, causal, st);
  }
}

extern "C" int flash_dq_launch(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq_, int64_t BH,
                               int64_t S, int64_t D, float scale, int causal,
                               void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ndv_for(D)) {
    case 1: return dq<1>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 2: return dq<2>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 4: return dq<4>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    default: return dq<8>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
  }
}

extern "C" int flash_dkv_launch(const float* q, const float* k,
                                const float* v, const float* dout,
                                const float* lse, const float* delta,
                                float* dk, float* dv, int64_t BH, int64_t S,
                                int64_t D, float scale, int causal,
                                void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ndv_for(D)) {
    case 1: return dkv<1>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 2: return dkv<2>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 4: return dkv<4>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    default: return dkv<8>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
  }
}
