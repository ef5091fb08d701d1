// Flash attention for Hopper in fp32 accuracy on the tensor cores: the
// online-softmax forward and the two recompute-from-LSE backward kernels,
// over (BH, S, D) MHA-layout tensors (row-major, contiguous), causal or not,
// any S, D <= 256.
//
// Replaces the three TPU kernels of src/repro/kernels/attention.py:
//   * _fwd_kernel (pallas_call in _fwd_padded)  -> flash_fwd_kernel  (K6)
//   * _dq_kernel  (pallas_call in _bwd_padded)  -> flash_dq_kernel   (K7a)
//   * _dkv_kernel (pallas_call in _bwd_padded)  -> flash_dkv_kernel  (K7b)
// with the reference's semantics: scores = (q . k) * scale with scale =
// 1/sqrt(real D) passed in by the caller, validity from *global* indices
// against the real S (key j visible to query i iff j < S and, causal, j <=
// i), masked scores = NEG_INF = -1e30 (not -inf), the denominator floored at
// 1e-30, LSE = m + log(l), and in the backward P = exp(s - LSE),
// dS = P * (dP - delta) * scale with delta = rowsum(dO * O) computed by the
// caller.  Every output element has one writer: no atomics, deterministic.
//
// Bound on the H100: operations.  Each visible (query, key) pair costs 4D
// flops in the forward, 6D in dQ and 8D in dK/dV, against 4-5 bytes per
// element of input and output: at D = 128, S = 512 that is far above the
// ridge.  The products run on the tensor cores in 3xTF32, three TF32 MMAs
// per fp32-accurate product, so the roofline is 495 / 3 = 165 TFLOP/s
// (0.2086 / 0.3130 / 0.4173 ms at BH 512, S 512, D 128, causal).
//
// Precision ("TF32 off" semantics): every product runs in 3xTF32, each fp32
// operand split into a TF32 big and the remainder small (tf32x3.cuh, which
// holds the split, the MMA and the fragment loops this file shares with
// wkv6.cu).  The small terms go to an accumulator of their own, and in the
// backward each tile's products over keys or queries to a zeroed register
// block, added in fp32; on the H100 that cuts the largest error against the
// plain fp32 versions, most in dK/dV.
//
// Design (FA2-style tiles on mma.sync.aligned.m16n8k8 tf32):
//   * up to D 128 a CTA is 4 warps, each owning 16 rows: query rows of a
//     64-row query tile for the forward and dQ, key rows of a 64-row key
//     tile for dK/dV;
//     the other index streams through shared memory in steps of 32 keys
//     (forward, dQ) or 32 queries (dK/dV).  The forward takes 67,584 bytes
//     of shared memory and at most 170 registers a thread, so three CTAs
//     share an SM; dQ and dK/dV (~100 KB, up to 255 registers) two;
//   * row statistics (max, sum, LSE, delta) live in registers and reduce
//     over the 4 lanes of a quad (shuffles with offsets 1 and 2);
//   * every product is register-A, shared-B.  Products over the head dim
//     (S = Q K^T, dP = dO V^T, and for dK/dV the transposed S^T = K Q^T,
//     dP^T = V dO^T) read A and B fragments from the staged tiles.  Products
//     over keys or queries (P V, dS K, P^T dO, dS^T Q) take the score tile's
//     C fragment as their A fragment without shared memory: C holds columns
//     (2t, 2t+1) of a thread's rows, A wants (t, t+4), and since the product
//     sums over that index it is relabelled — A = (c0, c2, c1, c3) and B's
//     rows are read at 2t and 2t+1 instead of t and t+4;
//   * tiles are copied with cp.async (16 bytes where D % 4 == 0 and the
//     pointers are 16-byte aligned, else 4 bytes), zero-filled beyond S and
//     D, into rows of D_pad + 4 floats: 16-byte aligned, and the 8 rows of a
//     fragment load fall on distinct banks.  The two streamed tiles each have
//     one slot, refilled in turn, so the next tile of one loads while the
//     other is in use (forward: K(j+1) during P V(j), V(j+1) during
//     Q K(j+1)^T; dQ: V then K; dK/dV: Q then dO);
//   * D is padded to a power of two >= 16 up to 128, else to 192 or 256, in
//     the template (DP), and the MMA loops
//     are fully unrolled with no bound known only at run time (such guards
//     split them into blocks the scheduler cannot interleave, which costs
//     more than the padding), so the zero-filled columns go through the
//     MMAs.  A warp skips a streamed tile only when it has no visible pair
//     there (causal, or rows beyond S), and masks only tiles not wholly
//     visible;
//   * the heaviest query tiles launch first (the forward and dQ reverse
//     blockIdx.y; dK/dV's key tile 0, first already, has the longest loop);
//   * above D 128 (DP 192 and 256: Nemotron-4 and the Gemma family) a warp's
//     16 x DP accumulator would not fit in registers (the forward's O alone
//     is DP / 2 floats a thread, and dK/dV holds two).  So all three
//     kernels run there on CTAs of 8 warps, one CTA a 64-row tile over the
//     full head dim (flash_fwd_pair_kernel, flash_dq_pair_kernel,
//     flash_dkv_pair_kernel; grid z 1): 4 row groups of 16 rows, each a
//     pair of warps that split the head dim, DC = DP / 2 columns a warp.
//     Each warp of a pair computes its partial of the 16 x 32 score tiles
//     over its DC columns (S = Q K^T; in dQ also dP = dO V^T, in dK/dV
//     S^T = K Q^T and dP^T = V dO^T), the pair swaps its partials through
//     shared memory (a slot a warp, 16 KB), and each warp adds the two,
//     lo + hi: fp32 addition commutes, so both hold the same tile bit for
//     bit, and the same row statistics, P and dS.  Each warp then takes its
//     DC output columns (O = P V, dQ = dS K, dK = dS^T Q, dV = P^T dO) as
//     below D 128, and the column-half-0 warp writes the LSE.  Each
//     head-dim product thus runs once a tile.  The first swap of a step
//     rides on the tile's own __syncthreads: the partials are stored before
//     the barrier that frees K (forward), frees V (dQ, for dP) or says dO
//     has landed (dK/dV), and read after it.  The second (dQ's S, dK/dV's
//     dP^T) needs the pair's own named barrier (bar.sync 1 + row group, 64
//     threads), and a thread writes its partial into the partner's slot at
//     the places it has just read the first one from, so one buffer serves
//     both swaps.  Shared memory: forward 116,736 / 149,504 bytes, dQ
//     166,912 / 216,064, dK/dV 167,168 / 216,320 at DP 192 / 256
//     (`prepare` raises the dynamic limit): one CTA, 8 warps, an SM.
// Not done here: wgmma and TMA (TF32 wgmma takes B only K-major from shared
// memory, and 3xTF32 on it needs split big/small copies of every B tile).
#include "tf32x3.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int PAIR_THREADS = 2 * THREADS;  // the pair kernels: 4 warp pairs
constexpr int TILE = 64;    // rows a CTA owns: 16 a warp (a warp pair)
constexpr int FWD_KEYS = 32;  // keys per forward step
constexpr int DQ_KEYS = 32;   // keys per dQ step
constexpr int DKV_QUERIES = 32;  // queries per dK/dV step
constexpr float NEG_INF = -1e30f;
constexpr float TINY = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int XCH = 16 * 32;  // floats of a warp's partial score tile

// the head-dim blocks mma_cols takes in one group: g, or g / 2 where g
// does not divide the nd blocks (DC 96: 12 blocks)
__host__ __device__ constexpr int fit(int nd, int g) {
  return nd < g || nd % g == 0 ? g : g / 2;
}

// ---------------------------------------------------------------------------
// rows [row0, row0 + ROWS) of one (S, D) matrix into shared memory (row
// stride DP + 4), zeros beyond S and D, by the CTA's NT threads
template <int DP, int ROWS, int NT = THREADS>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S, int D, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    constexpr int C = DP / 4;
    for (int i = threadIdx.x; i < ROWS * C; i += NT) {
      const int r = i / C, d = 4 * (i % C), g = row0 + r;
      const bool ok = g < S && d < D;
      cp_async16(dst + r * LD + d, ok ? src + (int64_t)g * D + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += NT) {
      const int r = i / DP, d = i % DP, g = row0 + r;
      const bool ok = g < S && d < D;
      cp_async4(dst + r * LD + d, ok ? src + (int64_t)g * D + d : src, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// products over the head dim (split, mma and mma_cols: tf32x3.cuh)
// ---------------------------------------------------------------------------
// acc[nb] += A . B^T over DP head-dim columns, nb < NB: A is the warp's 16
// rows of As from row ra, B the rows 8 nb .. 8 nb + 7 of Bs; both are tiles
// with row stride LD (DP + 4, or a whole tile's when the pair kernels take
// half of its columns).  Each k-step issues the three passes over all
// n-blocks in turn, so NB independent MMAs separate two on one accumulator.
// The two small terms sum into their own accumulator, added to acc once at
// the end, so acc takes one tensor-core accumulation a k-step, not three.
template <int DP, int NB, int LD = DP + 4>
__device__ __forceinline__ void mma_dim(float (&acc)[NB][4],
                                        const float* As, int ra,
                                        const float* Bs, int g, int t) {
  const float* a_lo = As + (ra + g) * LD + t;
  const float* a_hi = a_lo + 8 * LD;
  const float* b_row = Bs + g * LD + t;
  float lo[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) lo[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const float a[4] = {a_lo[8 * kk], a_hi[8 * kk], a_lo[8 * kk + 4],
                        a_hi[8 * kk + 4]};
    uint32_t ab[4], as[4], bb[NB][2], bs[NB][2];
    split(a, ab, as);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float b[2] = {b_row[8 * nb * LD + 8 * kk],
                          b_row[8 * nb * LD + 8 * kk + 4]};
      split(b, bb[nb], bs[nb]);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(lo[nb], as, bb[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(lo[nb], ab, bs[nb]);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) mma(acc[nb], ab, bb[nb]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] += lo[nb][e];
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__device__ __forceinline__ bool visible(int qi, int kj, int S, int causal) {
  return qi < S && kj < S && (!causal || kj <= qi);
}

// One key step of the forward's online softmax on a warp's 16 x 8 NB
// scores s of rows row[0], row[1] from key k0: s scaled and masked (unless
// full) into P = exp(s - m_new), the running max m and denominator l
// updated, and alpha = exp(m - m_new), the factor the output rescales by.
template <int NB>
__device__ __forceinline__ void softmax_step(float (&s)[NB][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const int (&row)[2], int k0,
                                             int t, int S, int causal,
                                             bool full, float scale) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[nb][c] *= scale;
      if (full ||
          visible(row[c >> 1], k0 + 8 * nb + 2 * t + (c & 1), S, causal))
        mx[c >> 1] = fmaxf(mx[c >> 1], s[nb][c]);
    }
  float m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = expf(m[h] - m_new[h]);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1;
      const float p =
          full || visible(row[h], k0 + 8 * nb + 2 * t + (c & 1), S, causal)
              ? expf(s[nb][c] - m_new[h]) : 0.0f;
      s[nb][c] = p;
      rs[h] += p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
    m[h] = m_new[h];
  }
}

// The pair kernels' swap of a warp's 16 x 32 partial score tile (C
// fragments, 4 n-blocks): put_tile stores it lane-major into a slot, and
// add_tile adds a slot to it, so lane l of the other warp of the pair
// reads what lane l stored, in 16-byte accesses without bank conflicts.
__device__ __forceinline__ void put_tile(float* slot, const float (&x)[4][4],
                                         int lane) {
  float4* s4 = reinterpret_cast<float4*>(slot);
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
    s4[32 * nb + lane] = make_float4(x[nb][0], x[nb][1], x[nb][2], x[nb][3]);
}

__device__ __forceinline__ void add_tile(float (&x)[4][4], const float* slot,
                                         int lane) {
  const float4* s4 = reinterpret_cast<const float4*>(slot);
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const float4 y = s4[32 * nb + lane];
    x[nb][0] += y.x;
    x[nb][1] += y.y;
    x[nb][2] += y.z;
    x[nb][3] += y.w;
  }
}

// the 64 threads of warp pair `pair` (named barriers 1-4; 0 is
// __syncthreads')
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(1 + pair) : "memory");
}

// rows r0 and r0 + 8, columns c0 + 2t, c0 + 2t + 1 of each 8-column block
// of acc into a (S, D) matrix
template <int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const float (&acc)[DP / 8][4],
                                           int r0, int S, int D, int c0,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= S) continue;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int d = c0 + 8 * nd + 2 * t;
      if (d < D) out[(int64_t)r * D + d] = acc[nd][2 * h];
      if (d + 1 < D) out[(int64_t)r * D + d + 1] = acc[nd][2 * h + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// K6: forward up to D 128.  grid (BH, ceil(S / 64)); O (BH, S, D), LSE
// (BH, S)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(THREADS, 3)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int D, float scale,
                 int causal, int vec) {
  static_assert(DP <= 128, "above 128: flash_fwd_pair_kernel");
  constexpr int LD = DP + 4, NB = FWD_KEYS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + FWD_KEYS * LD;
  const int w = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int64_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE, ra = 16 * w;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<DP, TILE>(Qs, q + off, q0, S, D, vec);
  load_tile<DP, FWD_KEYS>(Ks, k + off, 0, S, D, vec);
  cp_commit();
  load_tile<DP, FWD_KEYS>(Vs, v + off, 0, S, D, vec);
  cp_commit();

  const int row[2] = {q0 + ra + g, q0 + ra + g + 8};
  const bool live = q0 + ra < S;  // the warp holds a real query row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.0f;
  const int nk = (S + FWD_KEYS - 1) / FWD_KEYS;
  const int kend = causal ? min((q0 + TILE - 1) / FWD_KEYS + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * FWD_KEYS;
    // every pair of the warp's tile visible: no mask to apply
    const bool full = k0 + FWD_KEYS <= S &&
                      (!causal || k0 + FWD_KEYS - 1 <= q0 + ra);
    float s[NB][4], alpha[2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // K(kt) has landed
    if (live) mma_dim<DP, NB>(s, Qs, ra, Ks, g, t);
    __syncthreads();  // every warp is done with K(kt)
    if (kt + 1 < kend)
      load_tile<DP, FWD_KEYS>(Ks, k + off, k0 + FWD_KEYS, S, D, vec);
    cp_commit();

    softmax_step(s, m, l, alpha, row, k0, t, S, causal, full, scale);
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] *= alpha[c >> 1];

    cp_wait<1>();
    __syncthreads();  // V(kt) has landed
    if (live) mma_cols<DP, NB, fit(DP / 8, 8), false>(acc, s, Vs, g, t);
    __syncthreads();  // every warp is done with V(kt)
    if (kt + 1 < kend)
      load_tile<DP, FWD_KEYS>(Vs, v + off, k0 + FWD_KEYS, S, D, vec);
    cp_commit();
  }
  const float li[2] = {fmaxf(l[0], TINY), fmaxf(l[1], TINY)};
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] /= li[c >> 1];
  store_rows<DP>(o + off, acc, q0 + ra + g, S, D, 0, t);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < S) lse[bh * S + row[h]] = m[h] + logf(li[h]);
  }
}

// ---------------------------------------------------------------------------
// K6 above D 128: grid (BH, ceil(S / 64)), 8 warps; warp w is row group
// w / 2 and column half w % 2 (the header's warp pairs)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_fwd_pair_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int S, int D, float scale,
                      int causal, int vec) {
  constexpr int LD = DP + 4, NB = FWD_KEYS / 8, DC = DP / 2;
  static_assert(NB == 4, "put_tile / add_tile swap 16 x 32 tiles");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * LD;
  float* Vs = Ks + FWD_KEYS * LD;
  float* Xs = Vs + FWD_KEYS * LD;  // partial score tiles, a slot a warp
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int c0 = (w & 1) * DC, ra = 16 * (w >> 1);  // O's columns, rows
  float* mine = Xs + w * XCH;
  const float* other = Xs + (w ^ 1) * XCH;
  const int64_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<DP, TILE, PAIR_THREADS>(Qs, q + off, q0, S, D, vec);
  load_tile<DP, FWD_KEYS, PAIR_THREADS>(Ks, k + off, 0, S, D, vec);
  cp_commit();
  load_tile<DP, FWD_KEYS, PAIR_THREADS>(Vs, v + off, 0, S, D, vec);
  cp_commit();

  const int row[2] = {q0 + ra + g, q0 + ra + g + 8};
  const bool live = q0 + ra < S;  // the pair holds a real query row
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[DC / 8][4];
#pragma unroll
  for (int nd = 0; nd < DC / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.0f;
  const int nk = (S + FWD_KEYS - 1) / FWD_KEYS;
  const int kend = causal ? min((q0 + TILE - 1) / FWD_KEYS + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * FWD_KEYS;
    // every pair of the row group's tile visible: no mask to apply
    const bool full = k0 + FWD_KEYS <= S &&
                      (!causal || k0 + FWD_KEYS - 1 <= q0 + ra);
    float s[NB][4], alpha[2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // K(kt) has landed
    if (live) {
      mma_dim<DC, NB, LD>(s, Qs + c0, ra, Ks + c0, g, t);
      put_tile(mine, s, lane);
    }
    __syncthreads();  // every warp is done with K(kt); the partials are in
    if (kt + 1 < kend)
      load_tile<DP, FWD_KEYS, PAIR_THREADS>(Ks, k + off, k0 + FWD_KEYS, S, D,
                                            vec);
    cp_commit();
    if (live) add_tile(s, other, lane);  // S = lo + hi, in both warps

    softmax_step(s, m, l, alpha, row, k0, t, S, causal, full, scale);
#pragma unroll
    for (int nd = 0; nd < DC / 8; ++nd)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nd][c] *= alpha[c >> 1];

    cp_wait<1>();
    __syncthreads();  // V(kt) has landed
    if (live)
      mma_cols<DC, NB, fit(DC / 8, 8), false, LD>(acc, s, Vs + c0, g, t);
    __syncthreads();  // every warp is done with V(kt)
    if (kt + 1 < kend)
      load_tile<DP, FWD_KEYS, PAIR_THREADS>(Vs, v + off, k0 + FWD_KEYS, S, D,
                                            vec);
    cp_commit();
  }
  const float li[2] = {fmaxf(l[0], TINY), fmaxf(l[1], TINY)};
#pragma unroll
  for (int nd = 0; nd < DC / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] /= li[c >> 1];
  store_rows<DC>(o + off, acc, q0 + ra + g, S, D, c0, t);
  if (t == 0 && c0 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row[h] < S) lse[bh * S + row[h]] = m[h] + logf(li[h]);
  }
}

// ---------------------------------------------------------------------------
// K7a: dQ up to D 128.  grid (BH, ceil(S / 64)), one CTA per query tile
// over key tiles
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dq,
                int S, int D, float scale, int causal, int vec) {
  static_assert(DP <= 128, "above 128: flash_dq_pair_kernel");
  constexpr int LD = DP + 4, NB = DQ_KEYS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + DQ_KEYS * LD;
  const int w = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int64_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE, ra = 16 * w;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<DP, TILE>(Qs, q + off, q0, S, D, vec);
  load_tile<DP, TILE>(Gs, dout + off, q0, S, D, vec);
  load_tile<DP, DQ_KEYS>(Vs, v + off, 0, S, D, vec);
  cp_commit();
  load_tile<DP, DQ_KEYS>(Ks, k + off, 0, S, D, vec);
  cp_commit();

  const int row[2] = {q0 + ra + g, q0 + ra + g + 8};
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = row[h] < S ? __ldg(lse + bh * S + row[h]) : 0.0f;
    dr[h] = row[h] < S ? __ldg(delta + bh * S + row[h]) : 0.0f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.0f;
  const int nk = (S + DQ_KEYS - 1) / DQ_KEYS;
  const int kend = causal ? min((q0 + TILE - 1) / DQ_KEYS + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * DQ_KEYS;
    // the warp has a visible pair in this key tile
    const bool work = q0 + ra < S && (!causal || k0 <= q0 + ra + 15);
    const bool full = k0 + DQ_KEYS <= S &&
                      (!causal || k0 + DQ_KEYS - 1 <= q0 + ra);
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = dp[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // V(kt) has landed
    if (work) mma_dim<DP, NB>(dp, Gs, ra, Vs, g, t);
    __syncthreads();  // every warp is done with V(kt)
    if (kt + 1 < kend)
      load_tile<DP, DQ_KEYS>(Vs, v + off, k0 + DQ_KEYS, S, D, vec);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // K(kt) has landed
    if (work) {
      mma_dim<DP, NB>(s, Qs, ra, Ks, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const bool ok = full || visible(row[h], k0 + 8 * nb + 2 * t + (c & 1),
                                          S, causal);
          const float p = ok ? expf(s[nb][c] * scale - lr[h]) : 0.0f;
          s[nb][c] = p * (dp[nb][c] - dr[h]) * scale;
        }
      mma_cols<DP, NB, fit(DP / 8, 8), true, LD>(acc, s, Ks, g, t);
    }
    __syncthreads();  // every warp is done with K(kt)
    if (kt + 1 < kend)
      load_tile<DP, DQ_KEYS>(Ks, k + off, k0 + DQ_KEYS, S, D, vec);
    cp_commit();
  }
  store_rows<DP>(dq + off, acc, q0 + ra + g, S, D, 0, t);
}

// ---------------------------------------------------------------------------
// K7a above D 128: grid (BH, ceil(S / 64)), 8 warps; warp w is row group
// w / 2 (16 queries) and column half w % 2 (the header's warp pairs)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_dq_pair_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int S, int D, float scale, int causal, int vec) {
  constexpr int LD = DP + 4, NB = DQ_KEYS / 8, DC = DP / 2;
  static_assert(NB == 4, "put_tile / add_tile swap 16 x 32 tiles");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TILE * LD;  // dO
  float* Ks = Gs + TILE * LD;
  float* Vs = Ks + DQ_KEYS * LD;
  float* Xs = Vs + DQ_KEYS * LD;  // partial score tiles, a slot a warp
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int pair = w >> 1, c0 = (w & 1) * DC;  // dQ's columns
  float* mine = Xs + w * XCH;
  float* other = Xs + (w ^ 1) * XCH;
  const int64_t bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE, ra = 16 * pair;
  const int64_t off = bh * (int64_t)S * D;
  load_tile<DP, TILE, PAIR_THREADS>(Qs, q + off, q0, S, D, vec);
  load_tile<DP, TILE, PAIR_THREADS>(Gs, dout + off, q0, S, D, vec);
  load_tile<DP, DQ_KEYS, PAIR_THREADS>(Vs, v + off, 0, S, D, vec);
  cp_commit();
  load_tile<DP, DQ_KEYS, PAIR_THREADS>(Ks, k + off, 0, S, D, vec);
  cp_commit();

  const int row[2] = {q0 + ra + g, q0 + ra + g + 8};
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lr[h] = row[h] < S ? __ldg(lse + bh * S + row[h]) : 0.0f;
    dr[h] = row[h] < S ? __ldg(delta + bh * S + row[h]) : 0.0f;
  }
  float acc[DC / 8][4];
#pragma unroll
  for (int nd = 0; nd < DC / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nd][c] = 0.0f;
  const int nk = (S + DQ_KEYS - 1) / DQ_KEYS;
  const int kend = causal ? min((q0 + TILE - 1) / DQ_KEYS + 1, nk) : nk;
  for (int kt = 0; kt < kend; ++kt) {
    const int k0 = kt * DQ_KEYS;
    // the row group has a visible pair in this key tile (the same for both
    // warps of a pair, so both take the pair's barrier)
    const bool work = q0 + ra < S && (!causal || k0 <= q0 + ra + 15);
    const bool full = k0 + DQ_KEYS <= S &&
                      (!causal || k0 + DQ_KEYS - 1 <= q0 + ra);
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = dp[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // V(kt) has landed
    if (work) {
      mma_dim<DC, NB, LD>(dp, Gs + c0, ra, Vs + c0, g, t);
      put_tile(mine, dp, lane);
    }
    __syncthreads();  // every warp is done with V(kt); the dP partials are in
    if (kt + 1 < kend)
      load_tile<DP, DQ_KEYS, PAIR_THREADS>(Vs, v + off, k0 + DQ_KEYS, S, D,
                                           vec);
    cp_commit();
    if (work) add_tile(dp, other, lane);  // dP = lo + hi, in both warps
    cp_wait<1>();
    __syncthreads();  // K(kt) has landed
    if (work) {
      mma_dim<DC, NB, LD>(s, Qs + c0, ra, Ks + c0, g, t);
      // into the partner's slot, at the places this thread has just read:
      // the partner reads its dP partial from this warp's slot
      put_tile(other, s, lane);
      pair_sync(pair);
      add_tile(s, mine, lane);  // S = lo + hi
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          const bool ok = full || visible(row[h], k0 + 8 * nb + 2 * t + (c & 1),
                                          S, causal);
          const float p = ok ? expf(s[nb][c] * scale - lr[h]) : 0.0f;
          s[nb][c] = p * (dp[nb][c] - dr[h]) * scale;
        }
      // dQ += dS K over this warp's columns
      mma_cols<DC, NB, fit(DC / 8, 8), true, LD>(acc, s, Ks + c0, g, t);
    }
    __syncthreads();  // every warp is done with K(kt)
    if (kt + 1 < kend)
      load_tile<DP, DQ_KEYS, PAIR_THREADS>(Ks, k + off, k0 + DQ_KEYS, S, D,
                                           vec);
    cp_commit();
  }
  store_rows<DC>(dq + off, acc, q0 + ra + g, S, D, c0, t);
}

// ---------------------------------------------------------------------------
// K7b: dK, dV up to D 128.  grid (BH, ceil(S / 64)), one CTA per key tile
// over query tiles from the diagonal; the transposed tiles S^T = K Q^T and
// dP^T = V dO^T keep the warp's keys as rows
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv, int S, int D, float scale,
                 int causal, int vec) {
  static_assert(DP <= 128, "above 128: flash_dkv_pair_kernel");
  constexpr int LD = DP + 4, NB = DKV_QUERIES / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + DKV_QUERIES * LD;  // dO
  float* Ls = Gs + DKV_QUERIES * LD;  // LSE of the query tile
  float* Ds = Ls + DKV_QUERIES;       // delta of the query tile
  const int w = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7,
            t = threadIdx.x & 3;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * TILE, ra = 16 * w;
  const int64_t off = bh * (int64_t)S * D;
  const int nq = (S + DKV_QUERIES - 1) / DKV_QUERIES;
  const int qbeg = causal ? k0 / DKV_QUERIES : 0;

  auto load_q = [&](int q0) {
    load_tile<DP, DKV_QUERIES>(Qs, q + off, q0, S, D, vec);
    if (threadIdx.x < 2 * DKV_QUERIES) {
      const int i = threadIdx.x % DKV_QUERIES, gq = q0 + i;
      const float* src = threadIdx.x < DKV_QUERIES ? lse : delta;
      float* dst = threadIdx.x < DKV_QUERIES ? Ls : Ds;
      cp_async4(dst + i, gq < S ? src + bh * S + gq : src, gq < S);
    }
  };
  load_tile<DP, TILE>(Ks, k + off, k0, S, D, vec);
  load_tile<DP, TILE>(Vs, v + off, k0, S, D, vec);
  load_q(qbeg * DKV_QUERIES);
  cp_commit();
  load_tile<DP, DKV_QUERIES>(Gs, dout + off, qbeg * DKV_QUERIES, S, D, vec);
  cp_commit();

  const int key[2] = {k0 + ra + g, k0 + ra + g + 8};
  float gk[DP / 8][4], gv[DP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DP / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) gk[nd][c] = gv[nd][c] = 0.0f;
  for (int qt = qbeg; qt < nq; ++qt) {
    const int q0 = qt * DKV_QUERIES;
    // the warp's keys have a visible pair in this query tile
    const bool work = k0 + ra < S &&
                      (!causal || k0 + ra <= q0 + DKV_QUERIES - 1);
    const bool full = q0 + DKV_QUERIES <= S && k0 + ra + 15 < S &&
                      (!causal || k0 + ra + 15 <= q0);
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nb][c] = dpt[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // K, V, Q(qt), LSE, delta have landed
    if (work) mma_dim<DP, NB>(st, Ks, ra, Qs, g, t);
    cp_wait<0>();
    __syncthreads();  // dO(qt) has landed
    if (work) {
      mma_dim<DP, NB>(dpt, Vs, ra, Gs, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * nb + 2 * t + (c & 1);
          const bool ok = full || visible(q0 + col, key[c >> 1], S, causal);
          const float p = ok ? expf(st[nb][c] * scale - Ls[col]) : 0.0f;
          st[nb][c] = p;
          dpt[nb][c] = p * (dpt[nb][c] - Ds[col]) * scale;
        }
      mma_cols<DP, NB, 4, true>(gk, dpt, Qs, g, t);  // dK += dS^T Q
    }
    __syncthreads();  // every warp is done with Q(qt), LSE, delta
    if (qt + 1 < nq) load_q(q0 + DKV_QUERIES);
    cp_commit();
    if (work) mma_cols<DP, NB, 4, true>(gv, st, Gs, g, t);  // dV += P^T dO
    __syncthreads();  // every warp is done with dO(qt)
    if (qt + 1 < nq)
      load_tile<DP, DKV_QUERIES>(Gs, dout + off, q0 + DKV_QUERIES, S, D,
                                 vec);
    cp_commit();
  }
  store_rows<DP>(dk + off, gk, k0 + ra + g, S, D, 0, t);
  store_rows<DP>(dv + off, gv, k0 + ra + g, S, D, 0, t);
}

// ---------------------------------------------------------------------------
// K7b above D 128: grid (BH, ceil(S / 64)), 8 warps; warp w is row group
// w / 2 (16 keys) and column half w % 2 (the header's warp pairs)
// ---------------------------------------------------------------------------
template <int DP>
__global__ void __launch_bounds__(PAIR_THREADS, 1)
flash_dkv_pair_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int D, float scale,
                      int causal, int vec) {
  constexpr int LD = DP + 4, NB = DKV_QUERIES / 8, DC = DP / 2;
  static_assert(NB == 4, "put_tile / add_tile swap 16 x 32 tiles");
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * LD;
  float* Qs = Vs + TILE * LD;
  float* Gs = Qs + DKV_QUERIES * LD;  // dO
  float* Xs = Gs + DKV_QUERIES * LD;  // partial score tiles, a slot a warp
  float* Ls = Xs + 8 * XCH;           // LSE of the query tile
  float* Ds = Ls + DKV_QUERIES;       // delta of the query tile
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2,
            t = lane & 3;
  const int pair = w >> 1, c0 = (w & 1) * DC;  // dK's, dV's columns
  float* mine = Xs + w * XCH;
  float* other = Xs + (w ^ 1) * XCH;
  const int64_t bh = blockIdx.x;
  const int k0 = blockIdx.y * TILE, ra = 16 * pair;
  const int64_t off = bh * (int64_t)S * D;
  const int nq = (S + DKV_QUERIES - 1) / DKV_QUERIES;
  const int qbeg = causal ? k0 / DKV_QUERIES : 0;

  auto load_q = [&](int q0) {
    load_tile<DP, DKV_QUERIES, PAIR_THREADS>(Qs, q + off, q0, S, D, vec);
    if (threadIdx.x < 2 * DKV_QUERIES) {
      const int i = threadIdx.x % DKV_QUERIES, gq = q0 + i;
      const float* src = threadIdx.x < DKV_QUERIES ? lse : delta;
      float* dst = threadIdx.x < DKV_QUERIES ? Ls : Ds;
      cp_async4(dst + i, gq < S ? src + bh * S + gq : src, gq < S);
    }
  };
  load_tile<DP, TILE, PAIR_THREADS>(Ks, k + off, k0, S, D, vec);
  load_tile<DP, TILE, PAIR_THREADS>(Vs, v + off, k0, S, D, vec);
  load_q(qbeg * DKV_QUERIES);
  cp_commit();
  load_tile<DP, DKV_QUERIES, PAIR_THREADS>(Gs, dout + off,
                                           qbeg * DKV_QUERIES, S, D, vec);
  cp_commit();

  const int key[2] = {k0 + ra + g, k0 + ra + g + 8};
  float gk[DC / 8][4], gv[DC / 8][4];
#pragma unroll
  for (int nd = 0; nd < DC / 8; ++nd)
#pragma unroll
    for (int c = 0; c < 4; ++c) gk[nd][c] = gv[nd][c] = 0.0f;
  for (int qt = qbeg; qt < nq; ++qt) {
    const int q0 = qt * DKV_QUERIES;
    // the row group's keys have a visible pair in this query tile (the
    // same for both warps of a pair, so both take the pair's barrier)
    const bool work = k0 + ra < S &&
                      (!causal || k0 + ra <= q0 + DKV_QUERIES - 1);
    const bool full = q0 + DKV_QUERIES <= S && k0 + ra + 15 < S &&
                      (!causal || k0 + ra + 15 <= q0);
    float st[NB][4], dpt[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[nb][c] = dpt[nb][c] = 0.0f;
    cp_wait<1>();
    __syncthreads();  // K, V, Q(qt), LSE, delta have landed
    if (work) {
      mma_dim<DC, NB, LD>(st, Ks + c0, ra, Qs + c0, g, t);
      put_tile(mine, st, lane);
    }
    cp_wait<0>();
    __syncthreads();  // dO(qt) has landed; the S^T partials are in
    if (work) {
      add_tile(st, other, lane);  // S^T = lo + hi, in both warps
      mma_dim<DC, NB, LD>(dpt, Vs + c0, ra, Gs + c0, g, t);
      // into the partner's slot, at the places this thread has just read:
      // the partner reads its S^T partial from this warp's slot
      put_tile(other, dpt, lane);
      pair_sync(pair);
      add_tile(dpt, mine, lane);  // dP^T = lo + hi
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * nb + 2 * t + (c & 1);
          const bool ok = full || visible(q0 + col, key[c >> 1], S, causal);
          const float p = ok ? expf(st[nb][c] * scale - Ls[col]) : 0.0f;
          st[nb][c] = p;
          dpt[nb][c] = p * (dpt[nb][c] - Ds[col]) * scale;
        }
      // dK += dS^T Q
      mma_cols<DC, NB, 4, true, LD>(gk, dpt, Qs + c0, g, t);
    }
    __syncthreads();  // every warp is done with Q(qt), LSE, delta
    if (qt + 1 < nq) load_q(q0 + DKV_QUERIES);
    cp_commit();
    if (work)
      mma_cols<DC, NB, 4, true, LD>(gv, st, Gs + c0, g, t);  // dV += P^T dO
    __syncthreads();  // every warp is done with dO(qt)
    if (qt + 1 < nq)
      load_tile<DP, DKV_QUERIES, PAIR_THREADS>(Gs, dout + off,
                                               q0 + DKV_QUERIES, S, D, vec);
    cp_commit();
  }
  store_rows<DC>(dk + off, gk, k0 + ra + g, S, D, c0, t);
  store_rows<DC>(dv + off, gv, k0 + ra + g, S, D, c0, t);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// above D 128 the three kernels run on warp pairs: 8 warps a CTA and a
// slot of shared memory a warp for its partial score tiles
constexpr int pair_threads(int DP) {
  return DP <= 128 ? THREADS : PAIR_THREADS;
}

constexpr size_t pair_slots(int DP) {
  return DP <= 128 ? 0 : sizeof(float) * 8 * XCH;
}

template <int DP>
constexpr size_t fwd_smem() {
  return sizeof(float) * (TILE + 2 * FWD_KEYS) * (DP + 4) + pair_slots(DP);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * TILE + 2 * DQ_KEYS) * (DP + 4) +
         pair_slots(DP);
}

template <int DP>
constexpr size_t dkv_smem() {
  return sizeof(float) *
             ((2 * TILE + 2 * DKV_QUERIES) * (DP + 4) + 2 * DKV_QUERIES) +
         pair_slots(DP);
}

template <int DP>
auto fwd_kernel() {
  if constexpr (DP <= 128) return flash_fwd_kernel<DP>;
  else return flash_fwd_pair_kernel<DP>;
}

template <int DP>
auto dq_kernel() {
  if constexpr (DP <= 128) return flash_dq_kernel<DP>;
  else return flash_dq_pair_kernel<DP>;
}

template <int DP>
auto dkv_kernel() {
  if constexpr (DP <= 128) return flash_dkv_kernel<DP>;
  else return flash_dkv_pair_kernel<DP>;
}

bool bad_shape(int64_t BH, int64_t S, int64_t D) {
  return BH <= 0 || S <= 0 || D <= 0 || D > 256 || BH > 0x7fffffff ||
         S > 0x7fffffff || (S + TILE - 1) / TILE > 65535;
}

// (BH, query or key tiles)
dim3 grid_for(int64_t BH, int64_t S) {
  return dim3((unsigned)BH, (unsigned)((S + TILE - 1) / TILE));
}

// 16-byte copies need D % 4 == 0 and 16-byte aligned tensors
bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int DP>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int64_t BH, int64_t S, int64_t D, float scale, int causal,
        cudaStream_t st) {
  const auto kern = fwd_kernel<DP>();
  cudaError_t err = prepare((const void*)kern, fwd_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_for(BH, S), pair_threads(DP), fwd_smem<DP>(), st>>>(
      q, k, v, o, lse, (int)S, (int)D, scale, causal,
      D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v));
  return (int)cudaGetLastError();
}

template <int DP>
int dq(const float* q, const float* k, const float* v, const float* dout,
       const float* lse, const float* delta, float* dq_, int64_t BH,
       int64_t S, int64_t D, float scale, int causal, cudaStream_t st) {
  const auto kern = dq_kernel<DP>();
  cudaError_t err = prepare((const void*)kern, dq_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_for(BH, S), pair_threads(DP), dq_smem<DP>(), st>>>(
      q, k, v, dout, lse, delta, dq_, (int)S, (int)D, scale, causal,
      D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(dout));
  return (int)cudaGetLastError();
}

template <int DP>
int dkv(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dk, float* dv,
        int64_t BH, int64_t S, int64_t D, float scale, int causal,
        cudaStream_t st) {
  const auto kern = dkv_kernel<DP>();
  cudaError_t err = prepare((const void*)kern, dkv_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  kern<<<grid_for(BH, S), pair_threads(DP), dkv_smem<DP>(), st>>>(
      q, k, v, dout, lse, delta, dk, dv, (int)S, (int)D, scale, causal,
      D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
          aligned16(dout));
  return (int)cudaGetLastError();
}

// registers, local (spill) bytes, dynamic shared memory bytes, resident
// CTAs per SM, threads a CTA and grid z (1: one CTA a tile) of kernel
// `which` (0 forward, 1 dQ, 2 dK/dV)
template <int DP>
int info(int which, int* out) {
  const void* fn = which == 0   ? (const void*)fwd_kernel<DP>()
                   : which == 1 ? (const void*)dq_kernel<DP>()
                                : (const void*)dkv_kernel<DP>();
  const size_t smem = which == 0   ? fwd_smem<DP>()
                      : which == 1 ? dq_smem<DP>()
                                   : dkv_smem<DP>();
  const int err = kernel_resources(fn, pair_threads(DP), smem, out);
  out[4] = pair_threads(DP);
  out[5] = 1;
  return err;
}

int dp_for(int64_t D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128
       : D <= 192 ? 192 : 256;
}

}  // namespace

extern "C" int flash_fwd_launch(const float* q, const float* k,
                                const float* v, float* o, float* lse,
                                int64_t BH, int64_t S, int64_t D, float scale,
                                int causal, void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dp_for(D)) {
    case 16: return fwd<16>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 32: return fwd<32>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 64: return fwd<64>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 128: return fwd<128>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    case 192: return fwd<192>(q, k, v, o, lse, BH, S, D, scale, causal, st);
    default: return fwd<256>(q, k, v, o, lse, BH, S, D, scale, causal, st);
  }
}

extern "C" int flash_dq_launch(const float* q, const float* k, const float* v,
                               const float* dout, const float* lse,
                               const float* delta, float* dq_, int64_t BH,
                               int64_t S, int64_t D, float scale, int causal,
                               void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dp_for(D)) {
    case 16: return dq<16>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 32: return dq<32>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 64: return dq<64>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 128: return dq<128>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    case 192: return dq<192>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
    default: return dq<256>(q, k, v, dout, lse, delta, dq_, BH, S, D, scale, causal, st);
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
  switch (dp_for(D)) {
    case 16: return dkv<16>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 32: return dkv<32>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 64: return dkv<64>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 128: return dkv<128>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    case 192: return dkv<192>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
    default: return dkv<256>(q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale, causal, st);
  }
}

// out[6] = registers, spill (local) bytes, dynamic shared memory bytes,
// resident CTAs per SM, threads a CTA and grid z of kernel `which` (0
// forward, 1 dQ, 2 dK/dV) at D
extern "C" int flash_kernel_info(int which, int64_t D, int* out) {
  if (D <= 0 || D > 256 || which < 0 || which > 2)
    return (int)cudaErrorInvalidValue;
  switch (dp_for(D)) {
    case 16: return info<16>(which, out);
    case 32: return info<32>(which, out);
    case 64: return info<64>(which, out);
    case 128: return info<128>(which, out);
    case 192: return info<192>(which, out);
    default: return info<256>(which, out);
  }
}
