// Chunked WKV6 recurrence (RWKV-6 time-mix) for Hopper, fp32 accuracy on
// the tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::_wkv6_kernel
// (pallas_call in wkv6).  Per (batch, head), over T steps in chunks of
// L = 64 with the (hd, hd) state S carried from chunk to chunk:
//   cw[t]   = inclusive cumsum of log w over the chunk (per channel i)
//   cwx[t]  = cw[t] - log w[t] (the exclusive sum, as the reference takes it)
//   y[t,j]  = sum_i r[t,i] exp(cwx[t,i]) S[i,j]                       (inter)
//           + sum_{s<t} (sum_i r[t,i] k[s,i] exp(cwx[t,i] - cw[s,i])) v[s,j]
//           + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                       (bonus)
//   S[i,j] <- exp(cw[L-1,i]) S[i,j] + sum_s k[s,i] exp(cw[L-1,i] - cw[s,i]) v[s,j]
//
// Sub-chunks.  The chunk is cut into four 16-step sub-chunks.  A score with
// t and s in the same sub-chunk keeps the exact pairwise gate
// exp(cwx[t,i] - cw[s,i]) (the bonus on the diagonal).  A score with s in
// an earlier sub-chunk b < a (t in sub-chunk a) is factored through the
// log decay at the end of sub-chunk a - 1, ref = cw[16a - 1]:
//   exp(cwx[t] - cw[s]) = exp(cwx[t] - ref) * exp(ref - cw[s]),
// so that block is a product A B^T with A[t,i] = r[t,i] exp(cwx[t,i] -
// ref[i]) and B[s,i] = k[s,i] exp(ref[i] - cw[s,i]).  Both exponents are
// <= 0 up to the rounding of cw - log w (within an ulp of cw[t - 1]):
// log w <= 0 makes cw non-increasing, t - 1 >= 16a - 1 and s <= 16a - 1.
// So nothing overflows under any decay, and a factor that underflows to 0
// stands for a term below 1e-38 anyway.  This is not the
// rescaled exp(-cw) matmul form, whose factors grow without bound.
//
// Bound on the H100: bytes.  Per (sequence, head, chunk) at hd 64 the
// exact form's work is ~2 M operations (chip_smoke.py's wkv6_bound, the TPU
// kernel's count), of which the three products — (r exp(cwx)) S, scores V
// and the state update, 2 L hd^2 each and L (L + 1) hd — are 65%.  On the
// tensor cores in 3xTF32 (165 TFLOP/s) beside the rest on the CUDA cores
// (67 TFLOP/s) that takes less time than moving the 80 KB of inputs and
// outputs at 3.35 TB/s.
//
// Design (mma.sync.m16n8k8 TF32 in 3xTF32, tf32x3.cuh).  One CTA of eight
// warps per (batch, head), walking the chunks in order with S in shared
// memory.  Per chunk, each phase split evenly over the warps and ended by
// a barrier:
//   * copies: r, k, v and log w of a chunk go to shared memory with
//     cp.async (16 bytes where hd % 4 == 0 and the tensors are 16-byte
//     aligned), head dim zero-padded to DP in {16, 32, 64} (padded channels
//     have k = 0 and log w = 0; padded columns of y and S are never stored).
//     The next chunk's log w loads during the y products, its r during the
//     state update, its k during the next cumsum; v loads during the y
//     products' first part, since its buffer holds cw until then;
//   * cumsum: a thread per channel, serially (chunk_cumsum says why); cw
//     goes to v's buffer and cwx = cw - log w over log w, so neither is
//     shifted or recomputed later;
//   * scores P (64 x 64, lower triangle) into shared memory: warp w takes
//     half of the diagonal block of sub-chunk w / 2 — fp32 sums of 64
//     channels with accurate expf, three C-fragment-shaped entries a lane —
//     and one or two of the twelve 16 x 8 off-diagonal tiles, MMAs over the
//     head dim with both factors computed as fragments;
//   * r -> r exp(cwx) and k -> kdec = k exp(cw[L-1] - cw) in place;
//   * y: warp w computes columns 8w .. 8w + 7 of all 64 rows, (r exp(cwx)) S
//     + P V, four m-tiles (P V only over key blocks at or before each);
//   * the state update kdec^T V: warp w takes four 16 x 8 tiles of S, sums
//     the chunk's products in a zeroed register block and adds that to the
//     decayed S in fp32;
//   * shared rows have stride DP + 4 (P: 68), so fragment loads fall on
//     distinct banks.  S is kept transposed (S^T[j][i]): the y product's B
//     fragment and the state update's read-modify-write are conflict-free;
//     the state update's A = kdec^T reads k with the summed index
//     relabelled (rows 2t, 2t + 1 of a k-step), conflict-free too;
//   * the code is small on purpose: every warp runs one copy of each phase
//     (runtime sub-chunk and tile indices, k-loops unrolled twice).  Fully
//     unrolled per-warp template copies ran markedly slower on the H100:
//     their instructions did not fit the SM's instruction cache;
//   * 104,960 bytes of shared memory and at most 128 registers at DP 64:
//     two CTAs (16 warps) an SM, 512 CTAs in 1.94 waves on 132 SMs.
// Exponentials use expf (accurate), never __expf.
#include <math_constants.h>

#include "tf32x3.cuh"

namespace {

constexpr int L = 64;            // chunk length
constexpr int SUB = 16;          // sub-chunk: an m-tile of the MMAs
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAXHD = 64;        // largest head dim the layout holds

constexpr int PLD = L + 4;       // row stride of the scores P

template <int DP>
constexpr size_t wkv_smem() {
  // r, k, v, log w (L rows of DP + 4), P (L rows of L + 4), S^T (DP rows
  // of DP + 4), u and exp(cw[L-1])
  return sizeof(float) * (4 * L * (DP + 4) + L * PLD + DP * (DP + 4) + 2 * DP);
}

// the L rows of one chunk of a (B, T, H, hd) tensor into shared memory
// (row stride DP + 4): src is the chunk's (step 0, channel 0), steps are
// `step` floats apart; zeros beyond hd
template <int DP>
__device__ __forceinline__ void load_chunk(float* dst,
                                           const float* __restrict__ src,
                                           int64_t step, int hd, bool vec) {
  constexpr int LD = DP + 4;
  if (vec) {
    constexpr int C = DP / 4;
    for (int i = threadIdx.x; i < L * C; i += THREADS) {
      const int r = i / C, d = 4 * (i % C);
      const bool ok = d < hd;
      cp_async16(dst + r * LD + d, ok ? src + r * step + d : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < L * DP; i += THREADS) {
      const int r = i / DP, d = i % DP;
      const bool ok = d < hd;
      cp_async4(dst + r * LD + d, ok ? src + r * step + d : src, ok);
    }
  }
}

// log w (in W) -> its inclusive cumsum cw over the chunk (into CW) and
// cwx = cw - log w (over W): a thread per channel, serially in f32, the
// order of the plain version and of the model's wkv6_chunked.  A serial
// scan rounds each cw[t] from cw[t-1], so cw[t-1] - cw[s] carries only the
// roundings of the steps between them, and cwx[t] is cw[t-1] to within a
// rounding: a gate is as accurate as its span is short.  A segmented
// scan, or a float64 one rounded once, rounds every cw on its own, an
// error of half an ulp of |cw| on every difference however short: it put
// y 2.3x farther from a float64 run on an H100 (PERF.md).  The
// other warps wait at the caller's barrier, at no measured cost.
template <int DP>
__device__ __forceinline__ void chunk_cumsum(float* W, float* CW) {
  constexpr int LD = DP + 4;
  const int c = threadIdx.x;
  if (c >= DP) return;
  float acc = 0.0f;
#pragma unroll 16
  for (int r = 0; r < L; ++r) {
    const float x = W[r * LD + c];
    acc += x;
    CW[r * LD + c] = acc;
    W[r * LD + c] = acc - x;
  }
}

// Half of the diagonal block of sub-chunk a into Ps.  A lane's six
// entries are rows ta, tb against keys s0, s0 + 1 and row tb against keys
// s0 + 8, s0 + 9 (row ta against those is above the diagonal, zero from
// the start); half 0 takes (ta, s0), (ta, s0 + 1), (tb, s0), half 1 the
// other three.  Gated below the diagonal, u on it, 0 above; every
// exponential is taken (a masked one of -inf is 0) and the bonus selected
// after, so there is no branch and the chains interleave.  Both halves and
// every sub-chunk run one copy of the code.
template <int DP>
__device__ __forceinline__ void diag_scores(float* Ps, const float* R,
                                            const float* K, const float* CW,
                                            const float* CX, const float* U,
                                            int a, int half, int g, int t) {
  constexpr int LD = DP + 4;
  const int ta = SUB * a + g, tb = ta + 8, s0 = SUB * a + 2 * t;
  const bool lt0 = 2 * t < g, lt1 = 2 * t + 1 < g;
  const bool eq0 = 2 * t == g, eq1 = 2 * t + 1 == g;
  const int row[3] = {half ? tb : ta, half ? tb : ta, tb};
  const int key[3] = {s0 + (half ? 1 : 0), s0 + (half ? 8 : 1),
                      s0 + (half ? 9 : 0)};
  const bool lt[3] = {half ? true : lt0, half ? lt0 : lt1,
                      half ? lt1 : true};
  const bool eq[3] = {half ? false : eq0, half ? eq0 : eq1,
                      half ? eq1 : false};
  int ro[3], ko[3];   // row offsets of r and cwx, of k and cw
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ro[j] = row[j] * LD;
    ko[j] = key[j] * LD;
  }
  float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int i = 0; i < DP; ++i) {
    const float ui = U[i];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float x = CX[ro[j] + i];
      const float gate = expf(lt[j] ? x - CW[ko[j] + i] : -CUDART_INF_F);
      e[j] += R[ro[j] + i] * (eq[j] ? ui : gate) * K[ko[j] + i];
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) Ps[row[j] * PLD + key[j]] = e[j];
}

// Off-diagonal scores of rows of sub-chunk A against keys 8 nb0 .. 8 nb0 +
// 8 NN - 1 (all before 16 A) into Ps, as MMAs over the head dim of
// A[t,i] = r exp(cwx - ref) and B[s,i] = k exp(ref - cw), ref = cw[16A - 1]
template <int DP, int NN>
__device__ __forceinline__ void off_scores(float* Ps, const float* R,
                                           const float* K, const float* CW,
                                           const float* CX, int A, int nb0,
                                           int g, int t) {
  constexpr int LD = DP + 4, ND = DP / 8;
  const int ta = SUB * A + g, tb = ta + 8;
  const float* xa = CX + ta * LD;   // cwx rows
  const float* xb = CX + tb * LD;
  const float* ref = CW + (SUB * A - 1) * LD;
  float acc[NN][4], lo[NN][4];
#pragma unroll
  for (int nb = 0; nb < NN; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = lo[nb][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < ND; ++kk) {
    const int i0 = 8 * kk + t, i1 = i0 + 4;
    const float f0 = ref[i0], f1 = ref[i1];
    const float a[4] = {R[ta * LD + i0] * expf(xa[i0] - f0),
                        R[tb * LD + i0] * expf(xb[i0] - f0),
                        R[ta * LD + i1] * expf(xa[i1] - f1),
                        R[tb * LD + i1] * expf(xb[i1] - f1)};
    float b[NN][2];
#pragma unroll
    for (int nb = 0; nb < NN; ++nb) {
      const int s = 8 * (nb0 + nb) + g;
      b[nb][0] = K[s * LD + i0] * expf(f0 - CW[s * LD + i0]);
      b[nb][1] = K[s * LD + i1] * expf(f1 - CW[s * LD + i1]);
    }
    mma3<NN>(acc, lo, a, b);
  }
#pragma unroll
  for (int nb = 0; nb < NN; ++nb) {
    float* p = Ps + ta * PLD + 8 * (nb0 + nb) + 2 * t;
    p[0] = acc[nb][0] + lo[nb][0];
    p[1] = acc[nb][1] + lo[nb][1];
    p[8 * PLD] = acc[nb][2] + lo[nb][2];
    p[8 * PLD + 1] = acc[nb][3] + lo[nb][3];
  }
}

// the chunk's scores P into Ps: warp w half of the diagonal block of
// sub-chunk w / 2, and one or two of the twelve 16 x 8 off-diagonal tiles
// (row block, first key block, count): warps 0-3 take two, 4-7 one
template <int DP>
__device__ __forceinline__ void scores(float* Ps, const float* R,
                                       const float* K, const float* CW,
                                       const float* CX, const float* U, int w,
                                       int g, int t) {
  diag_scores<DP>(Ps, R, K, CW, CX, U, w >> 1, w & 1, g, t);
  // tiles (3; 0-1), (3; 2-3), (3; 4-5), (2; 0-1), (2; 2), (2; 3), (1; 0),
  // (1; 1)
  if (w < 4)
    off_scores<DP, 2>(Ps, R, K, CW, CX, w < 3 ? 3 : 2, w < 3 ? 2 * w : 0, g,
                      t);
  else
    off_scores<DP, 1>(Ps, R, K, CW, CX, w < 6 ? 2 : 1, w < 6 ? w - 2 : w - 6,
                      g, t);
}

// in place: r -> r exp(cwx), k -> kdec = k exp(cw[L-1] - cw);
// DL = exp(cw[L-1])
template <int DP>
__device__ __forceinline__ void decay(float* R, float* K, const float* CW,
                                      const float* CX, float* DL) {
  constexpr int LD = DP + 4;
  for (int idx = threadIdx.x; idx < L * DP; idx += THREADS) {
    const int t = idx / DP, i = idx % DP;
    const float cw = CW[t * LD + i], cwl = CW[(L - 1) * LD + i];
    R[t * LD + i] *= expf(CX[t * LD + i]);
    K[t * LD + i] *= expf(cwl - cw);
  }
  for (int i = threadIdx.x; i < DP; i += THREADS)
    DL[i] = expf(CW[(L - 1) * LD + i]);
}

// y[:, 8w .. 8w + 7] over the chunk's 64 rows (four m-tiles), in two
// parts with v's arrival between them: y_inter zeroes acc and lo and adds
// (r exp(cwx)) S; y_intra adds P V and stores y (row stride `step`,
// columns < hd)
template <int DP>
__device__ __forceinline__ void y_inter(float (&acc)[L / SUB][1][4],
                                        float (&lo)[L / SUB][1][4],
                                        const float* Rd, const float* ST,
                                        int w, int g, int t) {
  constexpr int LD = DP + 4, ND = DP / 8, MT = L / SUB;
  const int j0 = 8 * w;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][0][e] = lo[m][0][e] = 0.0f;
  // B = S[i][j] = S^T[j][i]
#pragma unroll 2
  for (int kk = 0; kk < ND; ++kk) {
    const int i0 = 8 * kk + t;
    uint32_t bb[1][2], bs[1][2];
    const float* srow = ST + (j0 + g) * LD;
    const float b[2] = {srow[i0], srow[i0 + 4]};
    split(b, bb[0], bs[0]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* ra = Rd + (SUB * m + g) * LD + i0;
      const float a[4] = {ra[0], ra[8 * LD], ra[4], ra[8 * LD + 4]};
      mma3_split<1>(acc[m], lo[m], a, bb, bs);
    }
  }
}

template <int DP>
__device__ __forceinline__ void y_intra(float (&acc)[L / SUB][1][4],
                                        float (&lo)[L / SUB][1][4],
                                        float* __restrict__ y, int64_t step,
                                        int hd, const float* Ps,
                                        const float* V, int w, int g, int t) {
  constexpr int LD = DP + 4, MT = L / SUB;
  const int j0 = 8 * w;
  // P V over the keys at or before each m-tile's rows: B = V rows 8 kb + t
#pragma unroll 2
  for (int kb = 0; kb < L / 8; ++kb) {
    uint32_t bb[1][2], bs[1][2];
    const float* vcol = V + (8 * kb + t) * LD + j0 + g;
    const float b[2] = {vcol[0], vcol[4 * LD]};
    split(b, bb[0], bs[0]);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < kb / 2) continue;      // keys after the m-tile's rows
      const float* pa = Ps + (SUB * m + g) * PLD + 8 * kb + t;
      const float a[4] = {pa[0], pa[8 * PLD], pa[4], pa[8 * PLD + 4]};
      mma3_split<1>(acc[m], lo[m], a, bb, bs);
    }
  }
  const int j = j0 + 2 * t;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* out = y + (SUB * m + g + 8 * hh) * step;
      if (j < hd) out[j] = acc[m][0][2 * hh] + lo[m][0][2 * hh];
      if (j + 1 < hd)
        out[j + 1] = acc[m][0][2 * hh + 1] + lo[m][0][2 * hh + 1];
    }
}

// S <- exp(cw[L-1]) S + kdec^T V for warp w's tiles of the state: the
// (DP / 16) x (DP / 8) tiles of 16 rows by 8 columns in row-major order,
// NBW consecutive ones a warp; the chunk's products sum in a zeroed block,
// added to the decayed S in fp32
template <int DP>
__device__ __forceinline__ void state_update(const float* Kd, const float* V,
                                             const float* DL, float* ST,
                                             int w, int g, int t) {
  constexpr int LD = DP + 4, ND = DP / 8, TILES = (DP / 16) * ND;
  constexpr int NBW = TILES >= WARPS ? TILES / WARPS : 1;
  if (w * NBW >= TILES) return;
  const int ia = SUB * (w * NBW / ND) + g, ib = ia + 8;
  const int j0 = 8 * (w * NBW % ND);
  float acc[NBW][4], lo[NBW][4];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = lo[nb][e] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < L / 8; ++kk) {
    // A = kdec^T, the summed index s relabelled: logical t <-> s0 = 8 kk +
    // 2t, t + 4 <-> s0 + 1; B = V rows s0, s0 + 1
    const int s0 = 8 * kk + 2 * t, s1 = s0 + 1;
    const float a[4] = {Kd[s0 * LD + ia], Kd[s0 * LD + ib], Kd[s1 * LD + ia],
                        Kd[s1 * LD + ib]};
    float b[NBW][2];
#pragma unroll
    for (int nb = 0; nb < NBW; ++nb) {
      b[nb][0] = V[s0 * LD + j0 + 8 * nb + g];
      b[nb][1] = V[s1 * LD + j0 + 8 * nb + g];
    }
    mma3<NBW>(acc, lo, a, b);
  }
  const float da = DL[ia], db = DL[ib];
#pragma unroll
  for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* p = ST + (j0 + 8 * nb + 2 * t + (e & 1)) * LD + (e < 2 ? ia : ib);
      *p = (e < 2 ? da : db) * *p + (acc[nb][e] + lo[nb][e]);
    }
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int64_t T, int H,
            int hd, int vec) {
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float smem[];
  float* R = smem;                 // r, then r exp(cwx)
  float* K = R + L * LD;           // k, then kdec
  float* V = K + L * LD;           // cw, then v
  float* W = V + L * LD;           // log w, then cwx = cw - log w
  float* Ps = W + L * LD;          // scores P (L, L + 4)
  float* ST = Ps + L * PLD;        // the state, transposed: ST[j][i] = S[i][j]
  float* U = ST + DP * LD;
  float* DL = U + DP;              // exp(cw[L-1])
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t step = (int64_t)H * hd;               // between time steps
  const int64_t base = (int64_t)b * T * step + (int64_t)h * hd;
  const int64_t sbase = (int64_t)bh * hd * hd;
  const int64_t nc = T / L;
  const bool y_cols_here = wid < DP / 8;  // owns 8 columns of y

  load_chunk<DP>(R, r + base, step, hd, vec);
  load_chunk<DP>(W, w + base, step, hd, vec);
  cp_commit();
  load_chunk<DP>(K, k + base, step, hd, vec);
  cp_commit();
  for (int idx = threadIdx.x; idx < DP * DP; idx += THREADS) {
    const int i = idx / DP, j = idx % DP;
    ST[j * LD + i] = i < hd && j < hd ? s0[sbase + i * hd + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < DP; i += THREADS)
    U[i] = i < hd ? u[(int64_t)h * hd + i] : 0.0f;
  // entries above each diagonal block are never written: zero once
  for (int i = threadIdx.x; i < L * PLD; i += THREADS) Ps[i] = 0.0f;

  for (int64_t c = 0; c < nc; ++c) {
    const int64_t cbase = base + c * L * step;
    const bool more = c + 1 < nc;
    cp_wait<1>();
    __syncthreads();  // r(c) and log w(c) have landed; S^T is this chunk's
    chunk_cumsum<DP>(W, V);
    cp_wait<0>();
    __syncthreads();  // cw and cwx final; k(c) has landed
    scores<DP>(Ps, R, K, V, W, U, wid, g, t);
    __syncthreads();  // every warp is done with r, k (raw) and P's tiles
    decay<DP>(R, K, V, W, DL);
    __syncthreads();  // cw and cwx are no longer read
    load_chunk<DP>(V, v + cbase, step, hd, vec);
    cp_commit();
    if (more) load_chunk<DP>(W, w + cbase + L * step, step, hd, vec);
    cp_commit();
    float acc[L / SUB][1][4], lo[L / SUB][1][4];
    if (y_cols_here) y_inter<DP>(acc, lo, R, ST, wid, g, t);
    cp_wait<1>();
    __syncthreads();  // v(c) has landed
    if (y_cols_here)
      y_intra<DP>(acc, lo, y + cbase, step, hd, Ps, V, wid, g, t);
    __syncthreads();  // every warp is done with r exp(cwx), P and S^T
    if (more) load_chunk<DP>(R, r + cbase + L * step, step, hd, vec);
    cp_commit();
    state_update<DP>(K, V, DL, ST, wid, g, t);
    __syncthreads();  // every warp is done with kdec and v; S^T is updated
    if (more) load_chunk<DP>(K, k + cbase + L * step, step, hd, vec);
    cp_commit();
  }
  for (int idx = threadIdx.x; idx < hd * hd; idx += THREADS)
    sT[sbase + idx] = ST[(idx % hd) * LD + idx / hd];
}

// 16-byte copies need hd % 4 == 0 and 16-byte aligned tensors
bool aligned16(const float* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int DP>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int64_t B,
           int64_t T, int64_t H, int64_t hd, cudaStream_t st) {
  cudaError_t err = prepare((const void*)wkv6_kernel<DP>, wkv_smem<DP>());
  if (err != cudaSuccess) return (int)err;
  const bool vec = hd % 4 == 0 && aligned16(r) && aligned16(k) &&
                   aligned16(v) && aligned16(w);
  wkv6_kernel<DP><<<(unsigned)(B * H), THREADS, wkv_smem<DP>(), st>>>(
      r, k, v, w, u, s0, y, sT, T, (int)H, (int)hd, vec);
  return (int)cudaGetLastError();
}

int dp_for(int64_t hd) { return hd <= 16 ? 16 : hd <= 32 ? 32 : 64; }

}  // namespace

extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* sT, int64_t B, int64_t T,
                           int64_t H, int64_t hd, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % L || hd <= 0 || hd > MAXHD ||
      B * H > 2147483647)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dp_for(hd)) {
    case 16: return launch<16>(r, k, v, w, u, s0, y, sT, B, T, H, hd, st);
    case 32: return launch<32>(r, k, v, w, u, s0, y, sT, B, T, H, hd, st);
    default: return launch<64>(r, k, v, w, u, s0, y, sT, B, T, H, hd, st);
  }
}

// out[4] = registers, spill (local) bytes, dynamic shared memory bytes and
// resident CTAs per SM of the kernel built for head dim hd
extern "C" int wkv6_kernel_info(int64_t hd, int* out) {
  if (hd <= 0 || hd > MAXHD) return (int)cudaErrorInvalidValue;
  switch (dp_for(hd)) {
    case 16:
      return kernel_resources((const void*)wkv6_kernel<16>, THREADS,
                              wkv_smem<16>(), out);
    case 32:
      return kernel_resources((const void*)wkv6_kernel<32>, THREADS,
                              wkv_smem<32>(), out);
    default:
      return kernel_resources((const void*)wkv6_kernel<64>, THREADS,
                              wkv_smem<64>(), out);
  }
}
