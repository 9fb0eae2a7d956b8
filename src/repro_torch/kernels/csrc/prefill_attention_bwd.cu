// Backward of the causal GQA prefill attention (prefill_attention.cu), for
// Hopper.
//
// Replaces what the reference gets from XLA's autodiff of its plain
// attention (src/repro/models/layers.py, naive_attention and
// blockwise_attention): the TPU kernel src/repro/kernels/prefill_attention/
// kernel.py has no gradient (pallas_call has no transpose rule), so the
// reference trains on the plain path. The forward is P = softmax(s) with
// s = cap * tanh(scale * q.k / cap) (s = scale * q.k without a cap), masked
// to kv_pos <= q_pos and kv_pos < kv_len, and O = P V over the KV head of
// each query head's group. Given dO, with P recomputed from the row
// log-sum-exp the forward wrote (lse, natural log) and D = rowsum(dO * O):
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * (1 - (s / cap)^2),
//     dQ = scale dS K,  dK = scale dS^T Q,
// with dK and dV summed over the query heads of a KV head's group.
//
// What bounds it on the card: five products of Sq x Skv x Dh per head
// (recomputed S, dP, dV, dK, dQ), halved by the causal mask, against eight
// tensors read or written once; at minicpm-2b's training shape (B=4, S=2048,
// 36 heads of 64) that is ~1.9e11 operations against ~0.3 GB, so it is
// bound by operations: the bf16 tensor-core rate.
//
// Three kernels, one C call, deterministic: no atomics, and every sum runs
// in a fixed order, so two calls on the same inputs give the same bits and a
// resumed training run is bit-identical on the card. (a) prefill_bwd_dot
// computes D = rowsum(dO * O) in f32, one warp per row. Then dK/dV and dQ,
// each in its own pass (dQ is owned by its block, so it needs no atomics),
// by one of two routes chosen by dtype in the wrapper, as the forward's (a
// fixed route, not a fallback):
//
// bf16, the training dtype: tensor cores (wgmma, sm90.cuh), f32 accumulators
// in registers, two warpgroups of 128 threads per block. The query rows are
// (position, query head) pairs of one KV head's group, packed position-major
// as the forward packs them, so a K/V tile serves every query head of the
// group and a sum over a tile's rows is a sum over the group's heads.
//   (b) prefill_bwd_dkdv_wgmma: one block per (batch, KV head, 128 KV rows),
//       64 rows per warpgroup, K and V in shared memory, dK and dV in
//       registers for the whole block. It walks the 64-row query tiles from
//       the first one holding a position >= its first KV row (a warpgroup
//       skips the tiles before its own first row) and, per tile, computes
//       in transposed form S^T = K Q^T and dP^T = V dO^T (K and V as A, Q
//       and dO as K-major B, from shared memory), P^T = 2^(s log2 e - lse
//       log2 e) of the scaled, capped scores, dS^T = P^T (dP^T - D)(1 -
//       (s/cap)^2), masked only on tiles that cross the causal edge,
//       kv_len or the last row, then
//       dV += P^T dO and dK += dS^T Q, with P^T and dS^T rounded to bf16 and
//       used in place as register A operands and dO and Q read MN-major
//       through the descriptor's transpose bit. At Dh = 256, dK and dV of
//       64 rows would take 256 registers a thread: there a block holds 64
//       KV rows, its two warpgroups split dK and dV's columns, 128 each, and
//       each recomputes S^T and dP^T (1.5x the products of the pass).
//   (c) prefill_bwd_dq_wgmma: one block per (batch, KV head, 128 packed
//       rows), as the forward's grid, 64 per warpgroup, Q and dO in shared
//       memory, dQ in registers; per KV tile up to min(kv_len, max q_pos +
//       1) (BK = 64 rows, 32 at Dh = 256): S = Q K^T, dP = dO V^T, dS in
//       registers, then dQ += dS K, dS in bf16 as register A and K read
//       MN-major.
//   Q/dO tiles in (b) and K/V tiles in (c) arrive by 16-byte cp.async into a
//   ring of up to 4 slots (`stages_of`: as many as fit 227 KB; 2 for (b)
//   and 3 for (c) at Dh = 256). The division by Hq / Hkv that unpacks a row
//   is a shift where that ratio is a power of two. Each kernel comes in a
//   version with and without the cap, so the uncapped one carries no tanh
//   or chain factor. Rounding: P to bf16 before dV, where the forward
//   rounds it before P V; dS to bf16 before dK and dQ (as FlashAttention's
//   backward); every sum in f32.
//   What bounds the route: it issues seven products per (query tile, KV
//   tile) pair where the bound counts five, because S and dP are
//   recomputed in both passes, so its own floor is 7/5 of the bound. On the
//   card it reaches some 20% of the tensor-core rate: one block per SM, one
//   block barrier per tile keeping the two warpgroups in step, each
//   warpgroup waiting on its products before its elementwise work (letting
//   the next tile's products overlap that work did not help: PERF.md), and
//   the copies issued by the same threads. What it leaves on the table: TMA
//   and a producer warp with mbarriers (freeing the warpgroups from the
//   block barrier), a persistent grid balancing the dK/dV pass where B x Hkv
//   is small (at llama3-8b's shape, 128 blocks whose first runs 128 query
//   tiles and whose last 8), the 128-byte swizzle.
//
// f32, the parity dtype: the first version's scalar kernels, kept because
// TF32 tensor cores cannot meet its 2e-5 tolerance. (b) prefill_bwd_dkdv:
// one block per (batch, KV head, KV tile of BK rows) keeps its K and V tile
// in shared memory and dK, dV in registers, and loops over the query heads
// of its group and the query tiles of BQ rows, skipping a tile whose rows
// all sit before the KV tile; (c) prefill_bwd_dq: one block per (batch,
// query head, query tile) keeps Q, dO in shared memory and dQ in registers,
// and loops over the KV tiles up to min(kv_len, max q_pos of the tile + 1).
// Both recompute S and dP of a BQ x BK tile with scalar f32 FMAs from f32
// shared tiles, 256 threads as a 16 x 16 grid, odd row strides so that the
// 16 rows a half-warp reads fall in 16 banks.
//
// Both routes mask the ragged edges themselves: query rows past Sq are never
// stored, and KV rows past the loop bound or kv_len are zero-filled in
// shared memory, never read, so NaN in the cache's tail cannot reach a
// gradient.

#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int NT = 256;  // threads per block, every kernel

// (a) D[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d], one warp per row.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
prefill_bwd_dot(const T* __restrict__ out, const T* __restrict__ dout, float* __restrict__ D,
                int64_t rows, int Sq, int Hq) {
  const int64_t r = (int64_t)blockIdx.x * (NT / 32) + threadIdx.x / 32;  // (b * Sq + i) * Hq + h
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < DH; d += 32) acc += to_f32(out[r * DH + d]) * to_f32(dout[r * DH + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = r % Hq, bi = r / Hq, i = bi % Sq, b = bi / Sq;
    D[(b * Hq + h) * Sq + i] = acc;
  }
}

template <typename T, int DH>
cudaError_t launch_dot(const void* out, const void* dout, void* D, int B, int Sq, int Hq,
                       cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * Hq;
  prefill_bwd_dot<T, DH><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<float*>(D), rows, Sq,
      Hq);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32, scalar
namespace scalar {

constexpr int BQ = 64;  // query rows per tile
constexpr int RQ = BQ / 16;

// KV rows per tile: 64, 32 at Dh = 256, where 64 would not fit shared memory
template <int DH>
__host__ __device__ constexpr int bk_of() { return DH > 128 ? 32 : 64; }

// Shared memory of (b) and (c): Q and dO tiles (BQ x (DH + 1)), K and V
// tiles (BK x (DH + 1)), P and dS (BQ x (BK + 1)).
template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * BQ * (DH + 1) + 2 * bk_of<DH>() * (DH + 1) +
                          2 * BQ * (bk_of<DH>() + 1));
}
static_assert(smem_bytes<256>() + 3 * BQ * 4 + 16 <= 232448, "fits a block's 227 KB");

template <int DH>
struct Smem {
  static constexpr int BK = bk_of<DH>(), LD = DH + 1, LDP = BK + 1;
  float *Qs, *dOs, *Ks, *Vs, *Ps, *dSs;
  __device__ explicit Smem(float* base) {
    Qs = base;
    dOs = Qs + BQ * LD;
    Ks = dOs + BQ * LD;
    Vs = Ks + BK * LD;
    Ps = Vs + BK * LD;
    dSs = Ps + BQ * LDP;
  }
};

// P and dS of one BQ x BK tile into shared memory: thread (ty, tx) computes
// query rows RQ ty .. RQ ty + RQ - 1 and KV columns tx + 16 c of S = Q K^T
// and dP = dO V^T, then P = exp(s - lse) (0 where masked) and dS = P (dP -
// D) times the cap's chain factor. pos / lse / D are the tile's rows (pos
// -1 for rows past the query's end, so every column is masked there); t0 is
// the KV tile's first row, kvl the valid prefix.
template <int DH>
__device__ __forceinline__ void p_ds_tile(const Smem<DH>& sm, const int* pos, const float* lse,
                                          const float* D, int t0, int kvl, float scale,
                                          float cap) {
  constexpr int BK = Smem<DH>::BK, CK = BK / 16, LD = Smem<DH>::LD, LDP = Smem<DH>::LDP;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CK; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float a[RQ], g[RQ], kk[CK], vv[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      a[i] = sm.Qs[(ty * RQ + i) * LD + d];
      g[i] = sm.dOs[(ty * RQ + i) * LD + d];
    }
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      kk[c] = sm.Ks[(tx + 16 * c) * LD + d];
      vv[c] = sm.Vs[(tx + 16 * c) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        s[i][c] = fmaf(a[i], kk[c], s[i][c]);
        dp[i][c] = fmaf(g[i], vv[c], dp[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty * RQ + i;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int col = t0 + tx + 16 * c;
      float p = 0.f, ds = 0.f;
      if (col < kvl && col <= pos[row]) {
        float x = s[i][c] * scale, fac = 1.f;
        if (cap > 0.f) {
          const float t = tanhf(x / cap);
          x = cap * t;
          fac = 1.f - t * t;
        }
        p = expf(x - lse[row]);
        ds = p * (dp[i][c] - D[row]) * fac;
      }
      sm.Ps[row * LDP + tx + 16 * c] = p;
      sm.dSs[row * LDP + tx + 16 * c] = ds;
    }
  }
}

// The query tile's rows q0 .. q0 + n_q - 1 of head h: Q and dO into shared
// memory, positions (-1 past n_q), lse and D; returns the tile's largest
// position (block-wide, by warp reductions: max_s holds one value per warp
// of the first BQ threads).
template <int DH>
__device__ __forceinline__ int load_q_tile(const Smem<DH>& sm, int* pos_s, float* lse_s,
                                           float* D_s, int* max_s, const float* q,
                                           const float* dout, const int* q_pos, const float* lse,
                                           const float* D, int b, int h, int q0, int n_q, int Sq,
                                           int Hq) {
  const int tid = threadIdx.x;
  int mx = -1;
  if (tid < BQ) {
    const bool ok = tid < n_q;
    const int p = ok ? q_pos[(int64_t)b * Sq + q0 + tid] : -1;
    const int64_t r = ((int64_t)b * Hq + h) * Sq + q0 + tid;
    pos_s[tid] = p;
    lse_s[tid] = ok ? lse[r] : 0.f;
    D_s[tid] = ok ? D[r] : 0.f;
    mx = p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (tid < BQ && tid % 32 == 0) max_s[tid / 32] = mx;
  const int64_t off = (((int64_t)b * Sq + q0) * Hq + h) * DH, stride = (int64_t)Hq * DH;
  {  // one tile at a time: the register buffer of a whole tile is large at Dh = 256
    RowTile<float, DH, BQ, NT> t;
    t.load(q + off, stride, n_q);
    t.store(sm.Qs, Smem<DH>::LD);
    t.load(dout + off, stride, n_q);
    t.store(sm.dOs, Smem<DH>::LD);
  }
  __syncthreads();
  int m = -1;
#pragma unroll
  for (int w = 0; w < BQ / 32; ++w) m = max(m, max_s[w]);
  return m;
}

template <int DH>
__device__ __forceinline__ void load_kv_tile(const Smem<DH>& sm, const float* k, const float* v,
                                             int b, int hk, int t0, int n_k, int Skv, int Hkv) {
  constexpr int BK = Smem<DH>::BK;
  const int64_t off = (((int64_t)b * Skv + t0) * Hkv + hk) * DH, stride = (int64_t)Hkv * DH;
  RowTile<float, DH, BK, NT> t;
  t.load(k + off, stride, n_k);
  t.store(sm.Ks, Smem<DH>::LD);
  t.load(v + off, stride, n_k);
  t.store(sm.Vs, Smem<DH>::LD);
}

// (b) dK and dV of one KV tile.
template <int DH>
__global__ void __launch_bounds__(NT)
prefill_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                 float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                 float scale, float cap) {
  constexpr int BK = Smem<DH>::BK, RK = BK / 16, EPT = DH / 16, LD = Smem<DH>::LD;
  constexpr int LDP = Smem<DH>::LDP;
  extern __shared__ float smem[];
  const Smem<DH> sm(smem);
  __shared__ int pos_s[BQ], max_s[BQ / 32];
  __shared__ float lse_s[BQ], D_s[BQ];
  const int t0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int qpk = Hq / Hkv;
  const int kvl = min(kv_len[b], Skv);
  const int n_k = max(0, min(BK, kvl - t0));

  float ak[RK][EPT], av[RK][EPT];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int e = 0; e < EPT; ++e) ak[r][e] = av[r][e] = 0.f;

  if (n_k > 0) {
    load_kv_tile<DH>(sm, k, v, b, hk, t0, n_k, Skv, Hkv);
    for (int g = 0; g < qpk; ++g) {
      const int h = hk * qpk + g;
      for (int q0 = 0; q0 < Sq; q0 += BQ) {
        const int n_q = min(BQ, Sq - q0);
        const int qmax = load_q_tile<DH>(sm, pos_s, lse_s, D_s, max_s, q, dout, q_pos, lse, D, b,
                                         h, q0, n_q, Sq, Hq);
        if (qmax < t0) {  // every row of the tile sits before the KV tile (uniform)
          __syncthreads();
          continue;
        }
        p_ds_tile<DH>(sm, pos_s, lse_s, D_s, t0, kvl, scale, cap);
        __syncthreads();
        for (int i = 0; i < n_q; ++i) {
          float go[EPT], qq[EPT];
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            go[e] = sm.dOs[i * LD + tx + 16 * e];
            qq[e] = sm.Qs[i * LD + tx + 16 * e];
          }
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            const float p = sm.Ps[i * LDP + ty * RK + r], ds = sm.dSs[i * LDP + ty * RK + r];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
              av[r][e] = fmaf(p, go[e], av[r][e]);
              ak[r][e] = fmaf(ds, qq[e], ak[r][e]);
            }
          }
        }
        __syncthreads();  // the next tile overwrites Q, dO, P and dS
      }
    }
  }
  // every row of the tile inside Skv, zeros past kv_len
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int row = t0 + ty * RK + r;
    if (row < Skv) {
      const int64_t o = (((int64_t)b * Skv + row) * Hkv + hk) * DH;
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        dk[o + tx + 16 * e] = ak[r][e] * scale;
        dv[o + tx + 16 * e] = av[r][e];
      }
    }
  }
}

// (c) dQ of one query tile.
template <int DH>
__global__ void __launch_bounds__(NT)
prefill_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ D,
               const int* __restrict__ q_pos, const int* __restrict__ kv_len,
               float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, float scale, float cap) {
  constexpr int BK = Smem<DH>::BK, EPT = DH / 16, LD = Smem<DH>::LD, LDP = Smem<DH>::LDP;
  extern __shared__ float smem[];
  const Smem<DH> sm(smem);
  __shared__ int pos_s[BQ], max_s[BQ / 32];
  __shared__ float lse_s[BQ], D_s[BQ];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hk = h / (Hq / Hkv);
  const int n_q = min(BQ, Sq - q0);
  const int kvl = min(kv_len[b], Skv);
  const int qmax = load_q_tile<DH>(sm, pos_s, lse_s, D_s, max_s, q, dout, q_pos, lse, D, b, h,
                                   q0, n_q, Sq, Hq);
  const int kv_end = min(kvl, qmax + 1);

  float acc[RQ][EPT];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;

  for (int t0 = 0; t0 < kv_end; t0 += BK) {
    const int n_k = min(BK, kv_end - t0);
    load_kv_tile<DH>(sm, k, v, b, hk, t0, n_k, Skv, Hkv);
    __syncthreads();
    p_ds_tile<DH>(sm, pos_s, lse_s, D_s, t0, kvl, scale, cap);
    __syncthreads();
    for (int j = 0; j < n_k; ++j) {
      float kk[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) kk[e] = sm.Ks[j * LD + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float ds = sm.dSs[(ty * RQ + i) * LDP + j];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[i][e] = fmaf(ds, kk[e], acc[i][e]);
      }
    }
    __syncthreads();  // the next tile overwrites K, V and dS
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = ty * RQ + i;
    if (row < n_q) {
      const int64_t o = (((int64_t)b * Sq + q0 + row) * Hq + h) * DH;
#pragma unroll
      for (int e = 0; e < EPT; ++e) dq[o + tx + 16 * e] = acc[i][e] * scale;
    }
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* D, const int* q_pos, const int* kv_len,
                   float* dq, float* dk, float* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  constexpr int BK = bk_of<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_bwd_dkdv<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(prefill_bwd_dq<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  prefill_bwd_dkdv<DH><<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, smem, stream>>>(
      q, k, v, dout, lse, D, q_pos, kv_len, dk, dv, Sq, Skv, Hq, Hkv, scale, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  prefill_bwd_dq<DH><<<dim3((Sq + BQ - 1) / BQ, Hq, B), NT, smem, stream>>>(
      q, k, v, dout, lse, D, q_pos, kv_len, dq, Sq, Skv, Hq, Hkv, scale, cap);
  return cudaGetLastError();
}

}  // namespace scalar

// -------------------------------------------------------------- bf16, wgmma
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BQ = 64;  // packed query rows per tile of the dK/dV pass, per warpgroup of the dQ pass
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_PER_BLOCK = 232448;  // 227 KB

constexpr int NWG = 2;               // consumer warpgroups per block (NT threads)
static_assert(NT == 128 * NWG, "a block is two warpgroups");

// At Dh = 256, dK and dV of 64 rows would take 256 registers a thread: the
// dK/dV pass's two warpgroups then take the same 64 KV rows and split dK and
// dV's columns (each recomputes S^T and dP^T)
template <int DH>
__host__ __device__ constexpr bool col_split() { return DH > 128; }
// KV rows per block of the dK/dV pass: 64 per warpgroup, or 64 shared by both
template <int DH>
__host__ __device__ constexpr int bkv_of() { return col_split<DH>() ? 64 : 64 * NWG; }
// KV rows per tile of the dQ pass: 64, or 32 where 64 would not fit
template <int DH>
__host__ __device__ constexpr int bk_of() { return DH > 128 ? 32 : 64; }

// (b): K and V of the block, then per slot a Q and a dO tile and the tile's
// positions, lse and D; (c): Q and dO of the block, then per slot a K and a
// V tile
template <int DH>
__host__ __device__ constexpr size_t dkdv_smem(int stages) {
  return sizeof(bf16) * 2 * bkv_of<DH>() * DH + stages * (sizeof(bf16) * 2 * BQ * DH + 3 * BQ * 4);
}
template <int DH>
__host__ __device__ constexpr size_t dq_smem(int stages) {
  return sizeof(bf16) * (2 * BQ * NWG * DH + stages * 2 * bk_of<DH>() * DH);
}
// The ring's slots: as many as 4 that fit the 227 KB a block may hold
// beside its static arrays (< 1 KB); 2 at least, checked below.
template <int DH, bool DKDV>
__host__ __device__ constexpr int stages_of() {
  int s = 4;
  while (s > 2 && (DKDV ? dkdv_smem<DH>(s) : dq_smem<DH>(s)) + 1024 > SMEM_PER_BLOCK) --s;
  return s;
}
template <int DH>
__host__ __device__ constexpr bool fits() {
  return dkdv_smem<DH>(stages_of<DH, true>()) + 1024 <= SMEM_PER_BLOCK &&
         dq_smem<DH>(stages_of<DH, false>()) + 1024 <= SMEM_PER_BLOCK;
}
static_assert(fits<16>() && fits<32>() && fits<64>() && fits<80>() && fits<128>() && fits<256>(),
              "the rings fit a block's shared memory");

// Packed row R of (b, hk) is query head hk * qpk + R % qpk at position
// R / qpk: its element offset in q, dout and dq, and its index in lse and D.
// Where qpk is a power of two the division is a shift.
struct Packed {
  int b, hk, qpk, shift, Sq, Hq, dh;
  __device__ Packed(int b_, int hk_, int qpk_, int Sq_, int Hq_, int dh_)
      : b(b_), hk(hk_), qpk(qpk_), shift(-1), Sq(Sq_), Hq(Hq_), dh(dh_) {
    for (int e = 0; e < 31; ++e)
      if (qpk == 1 << e) shift = e;
  }
  __device__ int pos_of(int R) const { return shift >= 0 ? R >> shift : R / qpk; }
  __device__ int64_t off(int R) const {
    const int i = pos_of(R);
    return ((int64_t)b * Sq + i) * Hq * dh + ((int64_t)hk * qpk + R - i * qpk) * dh;
  }
  __device__ int64_t row(int R) const {
    const int i = pos_of(R);
    return ((int64_t)b * Hq + (int64_t)hk * qpk + R - i * qpk) * Sq + i;
  }
};

// An accumulator of an m64nN product rounded to bf16, in the register A
// layout of the next product (sm90.cuh)
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16x2(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// P and dS of one score element, in place: s (the raw product q.k) becomes
// p = 2^(x log2 e - lse2), x the scaled and capped score, lse2 the row's lse
// in base 2, and dp becomes dS = p (dp - D) (1 - (x / cap)^2); both are 0
// where the element is not visible, so neither the exponential nor the
// chain factor of a masked element reaches the result.
template <bool CAP>
__device__ __forceinline__ void p_ds(float& s, float& dp, bool visible, float lse2, float d,
                                     float scale, float cap) {
  float p, fac = 1.f;
  if (CAP) {
    const float t = tanhf(s * scale / cap);
    p = fast_exp2(fmaf(t, cap * LOG2E, -lse2));
    fac = 1.f - t * t;
  } else {
    p = fast_exp2(fmaf(s, scale * LOG2E, -lse2));
  }
  dp = visible ? (CAP ? p * (dp - d) * fac : p * (dp - d)) : 0.f;
  s = visible ? p : 0.f;
}

// (b) dK and dV of the block's KV rows.
template <int DH, bool CAP>
__global__ void __launch_bounds__(NT, 1)
prefill_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ D,
                       const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                       int Hkv, float scale, float cap) {
  constexpr bool SPLIT = col_split<DH>();
  constexpr int BKV = bkv_of<DH>();
  constexpr int DC = SPLIT ? DH / 2 : DH, S = stages_of<DH, true>();
  constexpr int QT = BQ * DH;                 // elements of one Q or dO tile
  constexpr uint32_t GROUP = DH / 8 * 128;    // bytes between 8-row groups of a tile
  constexpr uint64_t SLOT = 2 * QT * sizeof(bf16) / 16, HALF = QT * sizeof(bf16) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BKV x DH
  bf16* Vs = Ks + BKV * DH;
  bf16* QDs = Vs + BKV * DH;  // slot s: Q at 2 s QT, dO after it
  int* pos_s = reinterpret_cast<int*>(QDs + 2 * S * QT);  // slot s at s BQ
  float* lse_s = reinterpret_cast<float*>(pos_s + S * BQ);
  float* D_s = lse_s + S * BQ;
  __shared__ int first_s[NT / 32][NWG];

  const int qpk = Hq / Hkv, NR = Sq * qpk, n_t = (NR + BQ - 1) / BQ;
  const int t0 = blockIdx.x * BKV, hk = blockIdx.y, b = blockIdx.z;
  const Packed pk(b, hk, qpk, Sq, Hq, DH);
  const int tid = threadIdx.x;
  // values that steer wgmma are broadcast from lane 0 (prefill_attention.cu)
  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid % 32;
  const int kvl = warp_uniform(min(kv_len[b], Skv));
  const int n_kv = max(0, min(BKV, kvl - t0));
  const int w0 = SPLIT ? 0 : 64 * wg;  // this warpgroup's first row in the block

  // The first position index whose q_pos reaches each warpgroup's first KV
  // row (Sq if none): the query tiles before its packed row see none of the
  // warpgroup's rows, whatever the positions after it.
  int f[NWG];
#pragma unroll
  for (int w = 0; w < NWG; ++w) f[w] = Sq;
  for (int i = tid; i < Sq && f[NWG - 1] == Sq; i += NT) {
    const int p = q_pos[(int64_t)b * Sq + i];
#pragma unroll
    for (int w = 0; w < NWG; ++w)
      if (f[w] == Sq && p >= t0 + (SPLIT ? 0 : 64 * w)) f[w] = i;
  }
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    f[w] = __reduce_min_sync(0xffffffffu, f[w]);
    if (lane == 0) first_s[tid / 32][w] = f[w];
  }
  __syncthreads();
  int j_first = 0x7fffffff, j_mine = 0;  // the block's first query tile, and this warpgroup's
#pragma unroll
  for (int w = 0; w < NWG; ++w) {
    int fw = Sq;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) fw = min(fw, first_s[i][w]);
    const int jw = (fw == Sq || t0 + (SPLIT ? 0 : 64 * w) >= kvl) ? n_t : fw * qpk / BQ;
    j_first = min(j_first, jw);
    if (w == wg) j_mine = jw;
  }
  j_first = warp_uniform(j_first);
  j_mine = warp_uniform(j_mine);

  const int64_t kv_stride = (int64_t)Hkv * DH;
  const bf16* kb = k + ((int64_t)b * Skv + t0) * kv_stride + (int64_t)hk * DH;
  const bf16* vb = v + ((int64_t)b * Skv + t0) * kv_stride + (int64_t)hk * DH;
  load_tile<DH, BKV, NT>(Ks, n_kv, [&](int r) { return kb + r * kv_stride; });
  load_tile<DH, BKV, NT>(Vs, n_kv, [&](int r) { return vb + r * kv_stride; });
  auto issue = [&](int j) {  // tile j's copies into its slot, as one commit group
    if (j < n_t) {
      const int R0 = j * BQ, n_q = min(BQ, NR - R0), s = j % S;
      bf16* slot = QDs + s * 2 * QT;
      load_tile<DH, BQ, NT>(slot, n_q, [&](int r) { return q + pk.off(R0 + r); });
      load_tile<DH, BQ, NT>(slot + QT, n_q, [&](int r) { return dout + pk.off(R0 + r); });
      if (tid < BQ) {
        const bool ok = tid < n_q;
        const int R = R0 + (ok ? tid : 0);
        const int64_t lr = pk.row(R);
        cp_async_4(pos_s + s * BQ + tid, q_pos + (int64_t)b * Sq + pk.pos_of(R), ok);
        cp_async_4(lse_s + s * BQ + tid, lse + lr, ok);
        cp_async_4(D_s + s * BQ + tid, D + lr, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < S - 1; ++j) issue(j_first + j);  // the first in the group of K and V

  // Operand descriptors: K and V of this warpgroup's rows as A; Q and dO
  // K-major as B of S^T and dP^T; Q and dO MN-major (from this warpgroup's
  // first column) as B of dK and dV. A slot is SLOT 16-byte units on.
  const uint64_t dKa = wgmma_desc(Ks + w0 * DH, 128, GROUP);
  const uint64_t dVa = wgmma_desc(Vs + w0 * DH, 128, GROUP);
  const uint64_t dQk = wgmma_desc(QDs, 128, GROUP);
  const uint64_t dQmn = wgmma_desc(QDs + (SPLIT ? wg * DC * 8 : 0), GROUP, 128);
  const int kr = t0 + w0 + warp * 16 + lane / 4;  // this thread's accumulator rows: kr, kr + 8
  float adk[DC / 2], adv[DC / 2];
  zero(adk);
  zero(adv);
  float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: rows kr (+ 8), columns the tile's rows
  uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // P^T and dS^T in bf16, as A operands

  // S^T and dP^T of tile j into st, dpt (issued, not committed)
  auto scores = [&](int j) {
    const uint64_t s = (uint64_t)(j % S) * SLOT;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(st, dKa + 16 * kk, dQk + s + 16 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss(dpt, dVa + 16 * kk, dQk + s + HALF + 16 * kk, kk > 0);
  };
  // dV += P^T dO and dK += dS^T Q of tile j (issued, not committed)
  auto grads = [&](int j) {
    const uint64_t s = (uint64_t)(j % S) * SLOT;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)  // 16 query rows = 2 row groups
      wgmma_rs(adv, pa[kk], dQmn + s + HALF + 2 * kk * GROUP / 16, 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs(adk, da[kk], dQmn + s + 2 * kk * GROUP / 16, 1);
  };
  // P^T and dS^T of tile j in place of st and dpt
  auto elementwise = [&](int j) {
    const int s = j % S, R0 = j * BQ;
    // this thread's columns are 8 i + 2 (lane % 4) + c2: a pair of
    // neighbours per i, and the 4 lanes of a row see every column
    const int2* ps = reinterpret_cast<const int2*>(pos_s + s * BQ) + lane % 4;
    const float2* ls = reinterpret_cast<const float2*>(lse_s + s * BQ) + lane % 4;
    const float2* dd = reinterpret_cast<const float2*>(D_s + s * BQ) + lane % 4;
    int pmin = INT_MAX;  // the tile's least position
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) pmin = min(pmin, min(ps[4 * i].x, ps[4 * i].y));
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, 1));
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, 2));
    // masks only where the tile crosses the causal edge, kv_len or the last row
    const int wr0 = t0 + w0;
    const bool edge = warp_uniform(R0 + BQ > NR || wr0 + 64 > kvl || pmin < wr0 + 63);
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i) {
      const int2 pc = ps[4 * i];
      const float2 l2 = ls[4 * i], d = dd[4 * i];
      const int c = R0 + 8 * i + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = kr + 8 * r;
        const bool rv = row < kvl;
        p_ds<CAP>(st[4 * i + 2 * r], dpt[4 * i + 2 * r], !edge || (rv && c < NR && row <= pc.x),
                  l2.x * LOG2E, d.x, scale, cap);
        p_ds<CAP>(st[4 * i + 2 * r + 1], dpt[4 * i + 2 * r + 1],
                  !edge || (rv && c + 1 < NR && row <= pc.y), l2.y * LOG2E, d.y, scale, cap);
      }
    }
  };
  // Step j: tile j's products, one after the other. Copies: tile j + S - 1
  // is issued at step j into the slot of tile j - 1, whose last reader (step
  // j - 1's products) the barrier of step j has seen finish.
  for (int j = j_first; j < n_t; ++j) {
    cp_async_wait<S - 2>();  // this thread's copies of tile j have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have
    issue(j + S - 1);
    if (j < j_mine) continue;  // uniform over the warpgroup
    zero(st);
    zero(dpt);
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    scores(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    elementwise(j);
    pack(st, pa);
    pack(dpt, da);
    fence_regs(pa);
    fence_regs(da);
    fence_regs(adv);
    fence_regs(adk);
    wgmma_fence();
    grads(j);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
  }
  cp_async_wait<0>();  // no copy outlives the block

  // every row inside Skv, zeros past kv_len
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + 8 * r;
    if (row < Skv) {
      const int64_t o = (((int64_t)b * Skv + row) * Hkv + hk) * DH + (SPLIT ? wg * DC : 0) +
                        2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < DC / 8; ++i) {
        *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * i) =
            __floats2bfloat162_rn(adk[4 * i + 2 * r] * scale, adk[4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * i) =
            __floats2bfloat162_rn(adv[4 * i + 2 * r], adv[4 * i + 2 * r + 1]);
      }
    }
  }
}

// (c) dQ of 64 packed rows per warpgroup.
template <int DH, bool CAP>
__global__ void __launch_bounds__(NT, 1)
prefill_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ D,
                     const int* __restrict__ q_pos, const int* __restrict__ kv_len,
                     bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, float scale,
                     float cap) {
  constexpr int BQD = BQ * NWG, S = stages_of<DH, false>();
  constexpr int BK = bk_of<DH>(), TILE = BK * DH;
  constexpr uint32_t GROUP = DH / 8 * 128;
  constexpr uint64_t SLOT = 2 * TILE * sizeof(bf16) / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQD x DH
  bf16* dOs = Qs + BQD * DH;
  bf16* KVs = dOs + BQD * DH;  // slot s: K at 2 s TILE, V after it
  __shared__ int wmax_s[NT / 32], wmin_s[NT / 32];

  const int qpk = Hq / Hkv, NR = Sq * qpk;
  const int n_rt = (NR + BQD - 1) / BQD;
  const int R0 = (n_rt - 1 - (int)blockIdx.x) * BQD;  // the longest row tiles start first
  const int hk = blockIdx.y, b = blockIdx.z;
  const Packed pk(b, hk, qpk, Sq, Hq, DH);
  const int tid = threadIdx.x;
  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid % 32;
  const int n_q = min(BQD, NR - R0);
  const int kvl = warp_uniform(min(kv_len[b], Skv));
  const int64_t kv_stride = (int64_t)Hkv * DH;
  const bf16* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * DH;
  const bf16* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * DH;

  load_tile<DH, BQD, NT>(Qs, n_q, [&](int r) { return q + pk.off(R0 + r); });
  load_tile<DH, BQD, NT>(dOs, n_q, [&](int r) { return dout + pk.off(R0 + r); });

  // this thread's accumulator rows r0 and r0 + 8: position (-1 past the
  // end, so every column is masked), lse in base 2, D
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  int pos[2], mx = -1, mn = INT_MAX;
  float l2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = r0 + 8 * r < n_q;
    const int R = R0 + r0 + 8 * r;
    pos[r] = valid ? q_pos[(int64_t)b * Sq + pk.pos_of(R)] : -1;
    l2[r] = valid ? lse[pk.row(R)] * LOG2E : 0.f;
    dd[r] = valid ? D[pk.row(R)] : 0.f;
    mx = max(mx, pos[r]);
    mn = min(mn, pos[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  if (lane == 0) {
    wmax_s[tid / 32] = mx;
    wmin_s[tid / 32] = mn;
  }
  __syncthreads();
  int block_max = -1, wg_max = -1, wg_lo = INT_MAX;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    block_max = max(block_max, wmax_s[w]);
    if (w / 4 == wg) {
      wg_max = max(wg_max, wmax_s[w]);
      wg_lo = min(wg_lo, wmin_s[w]);
    }
  }
  const int kv_end = warp_uniform(min(kvl, block_max + 1));  // the block reads no KV row past it
  const int n_tiles = (kv_end + BK - 1) / BK;
  // this warpgroup computes tiles 0 .. n_wg - 1: no row of it sees a column past them
  const int n_wg = warp_uniform((min(kvl, wg_max + 1) + BK - 1) / BK);
  wg_lo = warp_uniform(wg_lo);  // every row of the warpgroup sees every column <= wg_lo

  auto issue = [&](int t) {  // tile t's copies into its slot, as one commit group
    if (t < n_tiles) {
      const int t0 = t * BK, n_k = min(BK, kv_end - t0);
      bf16* slot = KVs + (t % S) * 2 * TILE;
      load_tile<DH, BK, NT>(slot, n_k, [&](int r) { return kb + (t0 + r) * kv_stride; });
      load_tile<DH, BK, NT>(slot + TILE, n_k, [&](int r) { return vb + (t0 + r) * kv_stride; });
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < S - 1; ++t) issue(t);  // the first in the group of Q and dO

  // Q and dO of this warpgroup's rows as A; K and V K-major as B of S and
  // dP; K MN-major as B of dQ
  const uint64_t dQa = wgmma_desc(Qs + wg * 64 * DH, 128, GROUP);
  const uint64_t dOa = wgmma_desc(dOs + wg * 64 * DH, 128, GROUP);
  const uint64_t dKk = wgmma_desc(KVs, 128, GROUP);
  const uint64_t dVk = wgmma_desc(KVs + TILE, 128, GROUP);
  const uint64_t dKmn = wgmma_desc(KVs, GROUP, 128);
  float acc[DH / 2];
  zero(acc);
  float s[BK / 2], dp[BK / 2];
  uint32_t da[BK / 16][4];  // dS in bf16, the A operand of dQ

  // S and dP of tile t into s, dp (issued, not committed)
  auto scores = [&](int t) {
    const uint64_t sl = (uint64_t)(t % S) * SLOT;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(s, dQa + 16 * kk, dKk + sl + 16 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) wgmma_ss(dp, dOa + 16 * kk, dVk + sl + 16 * kk, kk > 0);
  };
  // dQ += dS K of tile t (issued, not committed)
  auto grads = [&](int t) {
    const uint64_t sl = (uint64_t)(t % S) * SLOT;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 KV rows = 2 row groups
      wgmma_rs(acc, da[kk], dKmn + sl + 2 * kk * GROUP / 16, 1);
  };
  // P and dS of tile t in place of s and dp
  auto elementwise = [&](int t) {
    const int t0 = t * BK;
    // masks only where the tile crosses the causal edge or kv_len
    const bool edge = t0 + BK > kvl || t0 + BK - 1 > wg_lo;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = t0 + 8 * i + 2 * (lane % 4) + (e & 1), r = e / 2;
        p_ds<CAP>(s[4 * i + e], dp[4 * i + e], !edge || (col < kvl && col <= pos[r]), l2[r],
                  dd[r], scale, cap);
      }
    }
  };

  // Step t: tile t's products, one after the other, as (b)'s
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<S - 2>();  // this thread's copies of tile t have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; every read of tile t - 1's slot is done
    issue(t + S - 1);
    if (t >= n_wg) continue;  // uniform over the warpgroup
    zero(s);
    zero(dp);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    scores(t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    elementwise(t);
    pack(dp, da);
    fence_regs(da);
    fence_regs(acc);
    wgmma_fence();
    grads(t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row < n_q) {
      bf16* dst = dq + pk.off(R0 + row) + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
            __floats2bfloat162_rn(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
    }
  }
}

template <int DH, bool CAP>
cudaError_t launch_cap(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                       const float* lse, const float* D, const int* q_pos, const int* kv_len,
                       bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                       float scale, float cap, cudaStream_t stream) {
  constexpr size_t smem_kv = dkdv_smem<DH>(stages_of<DH, true>());
  constexpr size_t smem_q = dq_smem<DH>(stages_of<DH, false>());
  constexpr int BQD = BQ * NWG, BKV = bkv_of<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_bwd_dkdv_wgmma<DH, CAP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_kv);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(prefill_bwd_dq_wgmma<DH, CAP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  prefill_bwd_dkdv_wgmma<DH, CAP><<<dim3((Skv + BKV - 1) / BKV, Hkv, B), NT, smem_kv, stream>>>(
      q, k, v, dout, lse, D, q_pos, kv_len, dk, dv, Sq, Skv, Hq, Hkv, scale, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int qpk = Hq / Hkv;
  prefill_bwd_dq_wgmma<DH, CAP><<<dim3((Sq * qpk + BQD - 1) / BQD, Hkv, B), NT, smem_q, stream>>>(
      q, k, v, dout, lse, D, q_pos, kv_len, dq, Sq, Skv, Hq, Hkv, scale, cap);
  return cudaGetLastError();
}

// a kernel pair for each of: no cap, a cap (the chain factor and tanh)
template <int DH>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                   const float* lse, const float* D, const int* q_pos, const int* kv_len,
                   bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                   float scale, float cap, cudaStream_t stream) {
  return cap > 0.f ? launch_cap<DH, true>(q, k, v, dout, lse, D, q_pos, kv_len, dq, dk, dv, B,
                                          Sq, Skv, Hq, Hkv, scale, cap, stream)
                   : launch_cap<DH, false>(q, k, v, dout, lse, D, q_pos, kv_len, dq, dk, dv, B,
                                           Sq, Skv, Hq, Hkv, scale, cap, stream);
}

}  // namespace tc

// (a) on the stream, then (b) and (c) of the dtype's route.
template <typename T>
int entry(const void* q, const void* k, const void* v, const void* out, const void* dout,
          const void* lse, const void* q_pos, const void* kv_len, void* dq, void* dk, void* dv,
          void* D, int B, int Sq, int Skv, int Hq, int Hkv, int Dh, float scale, float cap,
          void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  return with_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    cudaError_t e = launch_dot<T, DH>(out, dout, D, B, Sq, Hq, st);
    if (e != cudaSuccess) return (int)e;
    const auto* lp = static_cast<const float*>(lse);
    const auto* Dp = static_cast<const float*>(D);
    const auto* pp = static_cast<const int*>(q_pos);
    const auto* kl = static_cast<const int*>(kv_len);
    if constexpr (std::is_same_v<T, float>)
      e = scalar::launch<DH>(static_cast<const T*>(q), static_cast<const T*>(k),
                             static_cast<const T*>(v), static_cast<const T*>(dout), lp, Dp, pp, kl,
                             static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), B, Sq,
                             Skv, Hq, Hkv, scale, cap, st);
    else
      e = tc::launch<DH>(static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), static_cast<const T*>(dout), lp, Dp, pp, kl,
                         static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), B, Sq, Skv,
                         Hq, Hkv, scale, cap, st);
    return (int)e;
  });
}

}  // namespace

// q, out, dout, dq (B, Sq, Hq, Dh); k, v, dk, dv (B, Skv, Hkv, Dh); lse and the
// scratch D (B, Hq, Sq) f32; q_pos (B, Sq) and kv_len (B,) int32; all
// contiguous, on the stream's device; Dh in {16, 32, 64, 80, 128, 256}; lse is
// what the forward wrote for the same q, k, v, q_pos, kv_len, scale and cap.
// Each launches (a), (b), (c) in order on the stream (f32: the scalar
// kernels; bf16: the wgmma kernels) and returns the first launch error
// (cudaError_t), 0 if none.
extern "C" int repro_prefill_attention_bwd_f32(const void* q, const void* k, const void* v,
                                               const void* out, const void* dout,
                                               const void* lse, const void* q_pos,
                                               const void* kv_len, void* dq, void* dk, void* dv,
                                               void* D, int B, int Sq, int Skv, int Hq, int Hkv,
                                               int Dh, float scale, float cap, void* stream) {
  return entry<float>(q, k, v, out, dout, lse, q_pos, kv_len, dq, dk, dv, D, B, Sq, Skv, Hq, Hkv,
                      Dh, scale, cap, stream);
}

extern "C" int repro_prefill_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                                const void* out, const void* dout,
                                                const void* lse, const void* q_pos,
                                                const void* kv_len, void* dq, void* dk, void* dv,
                                                void* D, int B, int Sq, int Skv, int Hq, int Hkv,
                                                int Dh, float scale, float cap, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, out, dout, lse, q_pos, kv_len, dq, dk, dv, D, B, Sq, Skv,
                              Hq, Hkv, Dh, scale, cap, stream);
}
