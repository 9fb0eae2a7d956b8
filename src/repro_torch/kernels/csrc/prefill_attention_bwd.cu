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
// log-sum-exp the forward wrote (lse) and D = rowsum(dO * O):
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * (1 - (s / cap)^2),
//     dQ = scale dS K,  dK = scale dS^T Q,
// with dK and dV summed over the query heads of a KV head's group.
//
// What bounds it on the card: five products of Sq x Skv x Dh per head
// (recomputed S, dP, dV, dK, dQ), halved by the causal mask, against eight
// tensors read or written once; at minicpm-2b's training shape (B=4, S=2048,
// 36 heads of 64) that is ~1.9e11 operations against ~0.3 GB, so it is
// bound by operations.
//
// Three kernels, one C call, deterministic (no atomics: a resumed training
// run is bit-identical on the card):
//   (a) prefill_bwd_dot: D = rowsum(dO * O) in f32, one warp per row;
//   (b) prefill_bwd_dkdv: one block per (batch, KV head, KV tile of BK
//       rows) keeps its K and V tile in shared memory and dK, dV in
//       registers, and loops over the query heads of its group and the
//       query tiles of BQ rows, skipping a tile whose rows all sit before
//       the KV tile (the causal mask);
//   (c) prefill_bwd_dq: one block per (batch, query head, query tile) keeps
//       Q, dO in shared memory and dQ in registers, and loops over the KV
//       tiles up to min(kv_len, max q_pos of the tile + 1), as the forward.
// Both (b) and (c) recompute S and dP of a BQ x BK tile with scalar f32 FMAs
// from f32 shared tiles (bf16 inputs are widened on load), 256 threads as a
// 16 x 16 grid, odd row strides so that the 16 rows a half-warp reads fall
// in 16 banks. This is the simple first version: no tensor cores, no TMA
// (ROADMAP B1 holds its redesign). One template serves f32 (the parity
// dtype) and bf16 (the training dtype); the arithmetic is f32 in both, and
// P is rounded through the input dtype before dV = P^T dO, where the
// forward rounds it before P V.

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads per block: a 16 x 16 grid
constexpr int BQ = 64;   // query rows per tile
constexpr int RQ = BQ / 16;

// KV rows per tile: 64, 32 at Dh = 256, where 64 would not fit shared memory
template <int DH>
__host__ __device__ constexpr int bk_of() { return DH > 128 ? 32 : 64; }

// Shared memory of (b) and (c), f32: Q and dO tiles (BQ x (DH + 1)), K and V
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
template <typename T, int DH>
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
      sm.Ps[row * LDP + tx + 16 * c] = round_through<T>(p);
      sm.dSs[row * LDP + tx + 16 * c] = ds;
    }
  }
}

// The query tile's rows q0 .. q0 + n_q - 1 of head h: Q and dO into shared
// memory, positions (-1 past n_q), lse and D; returns the tile's largest
// position (block-wide).
template <typename T, int DH>
__device__ __forceinline__ int load_q_tile(const Smem<DH>& sm, int* pos_s, float* lse_s,
                                           float* D_s, int* max_s, const T* q, const T* dout,
                                           const int* q_pos, const float* lse, const float* D,
                                           int b, int h, int q0, int n_q, int Sq, int Hq) {
  const int tid = threadIdx.x;
  if (tid == 0) *max_s = -1;
  __syncthreads();
  if (tid < BQ) {
    const bool ok = tid < n_q;
    const int p = ok ? q_pos[(int64_t)b * Sq + q0 + tid] : -1;
    const int64_t r = ((int64_t)b * Hq + h) * Sq + q0 + tid;
    pos_s[tid] = p;
    lse_s[tid] = ok ? lse[r] : 0.f;
    D_s[tid] = ok ? D[r] : 0.f;
    if (ok) atomicMax(max_s, p);
  }
  const int64_t off = (((int64_t)b * Sq + q0) * Hq + h) * DH, stride = (int64_t)Hq * DH;
  {  // one tile at a time: the register buffer of a whole tile is large at Dh = 256
    RowTile<T, DH, BQ, NT> t;
    t.load(q + off, stride, n_q);
    t.store(sm.Qs, Smem<DH>::LD);
    t.load(dout + off, stride, n_q);
    t.store(sm.dOs, Smem<DH>::LD);
  }
  __syncthreads();
  return *max_s;
}

template <typename T, int DH>
__device__ __forceinline__ void load_kv_tile(const Smem<DH>& sm, const T* k, const T* v, int b,
                                             int hk, int t0, int n_k, int Skv, int Hkv) {
  constexpr int BK = Smem<DH>::BK;
  const int64_t off = (((int64_t)b * Skv + t0) * Hkv + hk) * DH, stride = (int64_t)Hkv * DH;
  RowTile<T, DH, BK, NT> t;
  t.load(k + off, stride, n_k);
  t.store(sm.Ks, Smem<DH>::LD);
  t.load(v + off, stride, n_k);
  t.store(sm.Vs, Smem<DH>::LD);
}

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

// (b) dK and dV of one KV tile.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
prefill_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ D, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_len, T* __restrict__ dk, T* __restrict__ dv, int Sq,
                 int Skv, int Hq, int Hkv, float scale, float cap) {
  constexpr int BK = Smem<DH>::BK, RK = BK / 16, EPT = DH / 16, LD = Smem<DH>::LD;
  constexpr int LDP = Smem<DH>::LDP;
  extern __shared__ float smem[];
  const Smem<DH> sm(smem);
  __shared__ int pos_s[BQ], max_s;
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
    load_kv_tile<T, DH>(sm, k, v, b, hk, t0, n_k, Skv, Hkv);
    for (int g = 0; g < qpk; ++g) {
      const int h = hk * qpk + g;
      for (int q0 = 0; q0 < Sq; q0 += BQ) {
        const int n_q = min(BQ, Sq - q0);
        const int qmax = load_q_tile<T, DH>(sm, pos_s, lse_s, D_s, &max_s, q, dout, q_pos, lse,
                                            D, b, h, q0, n_q, Sq, Hq);
        if (qmax < t0) {  // every row of the tile sits before the KV tile (uniform)
          __syncthreads();
          continue;
        }
        p_ds_tile<T, DH>(sm, pos_s, lse_s, D_s, t0, kvl, scale, cap);
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
        dk[o + tx + 16 * e] = from_f32<T>(ak[r][e] * scale);
        dv[o + tx + 16 * e] = from_f32<T>(av[r][e]);
      }
    }
  }
}

// (c) dQ of one query tile.
template <typename T, int DH>
__global__ void __launch_bounds__(NT)
prefill_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ D, const int* __restrict__ q_pos,
               const int* __restrict__ kv_len, T* __restrict__ dq, int Sq, int Skv, int Hq,
               int Hkv, float scale, float cap) {
  constexpr int BK = Smem<DH>::BK, EPT = DH / 16, LD = Smem<DH>::LD, LDP = Smem<DH>::LDP;
  extern __shared__ float smem[];
  const Smem<DH> sm(smem);
  __shared__ int pos_s[BQ], max_s;
  __shared__ float lse_s[BQ], D_s[BQ];
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int hk = h / (Hq / Hkv);
  const int n_q = min(BQ, Sq - q0);
  const int kvl = min(kv_len[b], Skv);
  const int qmax = load_q_tile<T, DH>(sm, pos_s, lse_s, D_s, &max_s, q, dout, q_pos, lse, D, b,
                                      h, q0, n_q, Sq, Hq);
  const int kv_end = min(kvl, qmax + 1);

  float acc[RQ][EPT];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;

  for (int t0 = 0; t0 < kv_end; t0 += BK) {
    const int n_k = min(BK, kv_end - t0);
    load_kv_tile<T, DH>(sm, k, v, b, hk, t0, n_k, Skv, Hkv);
    __syncthreads();
    p_ds_tile<T, DH>(sm, pos_s, lse_s, D_s, t0, kvl, scale, cap);
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
      for (int e = 0; e < EPT; ++e) dq[o + tx + 16 * e] = from_f32<T>(acc[i][e] * scale);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, const void* q_pos, const void* kv_len, void* dq, void* dk, void* dv,
           void* D, int B, int Sq, int Skv, int Hq, int Hkv, float scale, float cap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  constexpr int BK = bk_of<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_bwd_dkdv<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(prefill_bwd_dq<T, DH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* Dp = static_cast<float*>(D);
  const int* pp = static_cast<const int*>(q_pos);
  const int* kl = static_cast<const int*>(kv_len);
  const int64_t rows = (int64_t)B * Sq * Hq;
  prefill_bwd_dot<T, DH><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const T*>(out), gp, Dp, rows, Sq, Hq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prefill_bwd_dkdv<T, DH><<<dim3((Skv + BK - 1) / BK, Hkv, B), NT, smem, stream>>>(
      qp, kp, vp, gp, lp, Dp, pp, kl, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv,
      scale, cap);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prefill_bwd_dq<T, DH><<<dim3((Sq + BQ - 1) / BQ, Hq, B), NT, smem, stream>>>(
      qp, kp, vp, gp, lp, Dp, pp, kl, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* out, const void* dout,
          const void* lse, const void* q_pos, const void* kv_len, void* dq, void* dk, void* dv,
          void* D, int B, int Sq, int Skv, int Hq, int Hkv, int Dh, float scale, float cap,
          void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(Dh, [&](auto dh) {
    return launch<T, decltype(dh)::value>(q, k, v, out, dout, lse, q_pos, kv_len, dq, dk, dv, D,
                                          B, Sq, Skv, Hq, Hkv, scale, cap,
                                          static_cast<cudaStream_t>(stream));
  });
}

}  // namespace

// q, out, dout, dq (B, Sq, Hq, Dh); k, v, dk, dv (B, Skv, Hkv, Dh); lse and the
// scratch D (B, Hq, Sq) f32; q_pos (B, Sq) and kv_len (B,) int32; all
// contiguous, on the stream's device; Dh in {16, 32, 64, 80, 128, 256}; lse is
// what the forward wrote for the same q, k, v, q_pos, kv_len, scale and cap.
// Each launches (a), (b), (c) in order on the stream and returns the first
// launch error (cudaError_t), 0 if none.
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
