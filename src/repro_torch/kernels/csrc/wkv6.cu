// Chunked WKV6 recurrence (RWKV-6 time-mix) for Hopper, fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::_wkv6_kernel
// (pallas_call in wkv6).  Per (batch, head), over T steps in chunks of
// L = 64 with the (hd, hd) state S carried from chunk to chunk:
//   cw      = inclusive cumsum of log w over the chunk (per channel i)
//   cwx     = cw - log w  (the exclusive sum)
//   y[t,j]  = sum_i r[t,i] exp(cwx[t,i]) S[i,j]                       (inter)
//           + sum_{s<t} (sum_i r[t,i] k[s,i] exp(cwx[t,i] - cw[s,i])) v[s,j]
//           + (sum_i r[t,i] u[i] k[t,i]) v[t,j]                       (bonus)
//   S[i,j] <- exp(cw[L-1,i]) S[i,j] + sum_s k[s,i] exp(cw[L-1,i] - cw[s,i]) v[s,j]
// Every exponent is <= 0 (log w <= 0, s < t), so nothing overflows under
// any decay: this is the exact log-space pairwise form, never the rescaled
// exp(-cw) matmul form.
//
// Bound on the H100: operations, narrowly.  Per (sequence, head, chunk) at
// hd 64 the pairwise gates are L(L-1)/2 * hd = 129,024 exponentials with
// their subtract and multiply-adds, and the products against the state,
// the scores and the state update add about 1.3 M more operations: ~2 M in
// all against 80 KB of inputs and output, 25 operations per byte, a little
// above the card's fp32 ridge of 20.
//
// Design.  One CTA of 256 threads per (batch, head), as the TPU's grid; a
// loop over the chunks inside it takes the place of the TPU's sequential
// fori_loop, with S in shared memory.  The TPU holds the (L, L, hd) gate
// tensor in VMEM (1 MB at hd 64); here no gate is ever stored: each
// (t, s) score computes its gates on the fly inside its reduction over i.
// Shared memory per CTA (hd <= 64): the chunk's r (then r exp(cwx)), k (then
// k exp(cw[L-1] - cw)), v, cw and cwx, the state and the (L, L) scores —
// 115,200 bytes, two CTAs per SM.  k and cw are padded to 65 columns
// because the score loop reads them with the warp's lanes on different
// rows; the other arrays are read along rows or broadcast.  Steps per
// chunk, each ending in a barrier: load; cumsum (one thread per channel,
// in order); scores (a warp per query row t, its lanes on key rows s, the
// diagonal holding the bonus); decay r and k in place; y (a warp per row
// t, lanes on output channels j) straight to device memory; state update.
// Exponentials use expf (accurate), never __expf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 64;            // chunk length
constexpr int MAXHD = 64;        // largest head dim the layout holds
constexpr int PAD = MAXHD + 1;   // row stride of the padded arrays
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES =
    sizeof(float) * (3 * L * MAXHD + MAXHD * MAXHD + L * L + 2 * L * PAD);

__global__ void __launch_bounds__(THREADS, 2)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT,
            int64_t T, int H, int hd) {
  extern __shared__ float sm[];
  float* R = sm;                  // [L][MAXHD]  r, then r * exp(cwx)
  float* CWX = R + L * MAXHD;     // [L][MAXHD]  log w, then cw - log w
  float* V = CWX + L * MAXHD;     // [L][MAXHD]
  float* S = V + L * MAXHD;       // [MAXHD][MAXHD] state
  float* SC = S + MAXHD * MAXHD;  // [L][L] scores, bonus on the diagonal
  float* K = SC + L * L;          // [L][PAD]  k, then k * exp(cw[L-1] - cw)
  float* CW = K + L * PAD;        // [L][PAD]  inclusive cumsum of log w

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int64_t step = (int64_t)H * hd;               // between time steps
  const int64_t base = (int64_t)b * T * step + (int64_t)h * hd;
  const float* uh = u + (int64_t)h * hd;
  const int64_t sbase = (int64_t)bh * hd * hd;
  const float* CWL = CW + (L - 1) * PAD;               // cw at the chunk end

  for (int idx = tid; idx < hd * hd; idx += THREADS)
    S[(idx / hd) * MAXHD + idx % hd] = s0[sbase + idx];

  for (int64_t c = 0; c < T / L; ++c) {
    const int64_t cbase = base + c * L * step;
    __syncthreads();  // the previous chunk's state update has read K and V
    for (int idx = tid; idx < L * hd; idx += THREADS) {
      const int t = idx / hd, i = idx % hd;
      const int64_t g = cbase + t * step + i;
      R[t * MAXHD + i] = r[g];
      K[t * PAD + i] = k[g];
      V[t * MAXHD + i] = v[g];
      CWX[t * MAXHD + i] = w[g];
    }
    __syncthreads();
    if (tid < hd) {
      float acc = 0.0f;
      for (int t = 0; t < L; ++t) {
        const float wt = CWX[t * MAXHD + tid];
        acc = acc + wt;
        CW[t * PAD + tid] = acc;
        CWX[t * MAXHD + tid] = acc - wt;
      }
    }
    __syncthreads();
    // scores: a warp per query row t, lanes on key rows s <= t
    for (int p = tid; p < L * L; p += THREADS) {
      const int t = p / L, s = p % L;
      if (s > t) continue;
      const float* Rt = R + t * MAXHD;
      const float* Ks = K + s * PAD;
      float acc = 0.0f;
      if (s < t) {
        const float* Xt = CWX + t * MAXHD;
        const float* Cs = CW + s * PAD;
        for (int i = 0; i < hd; ++i)
          acc += (Rt[i] * expf(Xt[i] - Cs[i])) * Ks[i];
      } else {
        for (int i = 0; i < hd; ++i) acc += (Rt[i] * __ldg(uh + i)) * Ks[i];
      }
      SC[t * L + s] = acc;
    }
    __syncthreads();
    for (int idx = tid; idx < L * hd; idx += THREADS) {
      const int t = idx / hd, i = idx % hd;
      R[t * MAXHD + i] *= expf(CWX[t * MAXHD + i]);
      K[t * PAD + i] *= expf(CWL[i] - CW[t * PAD + i]);
    }
    __syncthreads();
    // y: a warp per row t, lanes on output channels j
    for (int p = tid; p < L * MAXHD; p += THREADS) {
      const int t = p / MAXHD, j = p % MAXHD;
      if (j >= hd) continue;
      float inter = 0.0f, intra = 0.0f;
      for (int i = 0; i < hd; ++i) inter += R[t * MAXHD + i] * S[i * MAXHD + j];
      for (int s = 0; s <= t; ++s) intra += SC[t * L + s] * V[s * MAXHD + j];
      y[cbase + t * step + j] = inter + intra;
    }
    __syncthreads();  // y has read S
    for (int p = tid; p < MAXHD * MAXHD; p += THREADS) {
      const int i = p / MAXHD, j = p % MAXHD;
      if (i >= hd || j >= hd) continue;
      float acc = 0.0f;
      for (int s = 0; s < L; ++s) acc += K[s * PAD + i] * V[s * MAXHD + j];
      S[i * MAXHD + j] = expf(CWL[i]) * S[i * MAXHD + j] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < hd * hd; idx += THREADS)
    sT[sbase + idx] = S[(idx / hd) * MAXHD + idx % hd];
}

}  // namespace

extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* sT, int64_t B, int64_t T,
                           int64_t H, int64_t hd, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || T % L || hd <= 0 || hd > MAXHD ||
      B * H > 2147483647)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wkv6_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  wkv6_kernel<<<(unsigned)(B * H), THREADS, SMEM_BYTES,
                static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, s0, y, sT, T, (int)H, (int)hd);
  return (int)cudaGetLastError();
}
