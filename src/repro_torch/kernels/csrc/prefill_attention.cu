// Causal GQA flash attention of a query chunk over a KV prefix, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/prefill_attention/kernel.py
// (flash_prefill_attention, body _flash_kernel): out[b, i, h] attends over
// kv rows j of KV head h / (Hq / Hkv) with j <= q_pos[b, i] and
// j < kv_len[b], softmax in f32, optional tanh logit cap.
//
// What bounds it on the card: at the serving shapes (a 512-token chunk over
// a KV prefix of up to 2048 rows, Dh = 128) the work is 4 * Sq * Skv * Dh
// operations per head against (Sq + 2 * Skv) * Dh elements moved, far above
// the H100's ~295 operations per byte, so it is bound by operations. This
// first version runs them as f32 FMAs from shared memory (no tensor cores),
// so it can reach at best the f32 FMA rate; wgmma/TMA are for a later PR.
//
// Design. One block owns BQ = 64 query rows of one (batch, query head).
// The TPU kernel's sequential innermost grid axis over KV blocks becomes a
// loop inside the block, and it stops at min(kv_len, max q_pos of the tile
// + 1): tiles past the causal edge or the valid prefix are never read. The
// running max m, sum l and accumulator stay in f32 registers (online
// softmax); masked scores take the reference's finite -0.7 * FLT_MAX. The
// kernel masks the ragged edges itself (query rows past Sq are not stored,
// KV rows past the loop bound are zero-filled), so the wrapper pads nothing.
// 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3, score columns tx + 16 c, and output columns tx + 16 e.
// Q and K tiles are stored in f32 with an odd row stride so that the 16
// different K rows a half-warp reads fall in 16 different banks.

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // KV rows per tile
constexpr int NT = 256;       // threads per block
constexpr int ROWS = BQ / 16; // query rows per thread
constexpr int COLS = BK / 16; // score columns per thread

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ q_pos,
                         const int* __restrict__ kv_len, T* __restrict__ out, int Sq,
                         int Skv, int Hq, int Hkv, float scale, float cap) {
  constexpr int LDQ = DH + 1, LDK = DH + 1, LDV = DH, LDP = BK + 1;
  constexpr int EPT = DH / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x LDQ
  float* Ks = Qs + BQ * LDQ;    // BK x LDK
  float* Vs = Ks + BK * LDK;    // BK x LDV
  float* Ps = Vs + BK * LDV;    // BQ x LDP, probabilities of the tile
  __shared__ int pos_s[BQ];
  __shared__ int qmax_s;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_q = min(BQ, Sq - q0);
  const int kvl = min(kv_len[b], Skv);

  if (tid == 0) qmax_s = -1;
  __syncthreads();
  if (tid < BQ) {
    const int p = tid < n_q ? q_pos[(int64_t)b * Sq + q0 + tid] : 0;
    pos_s[tid] = p;
    if (tid < n_q) atomicMax(&qmax_s, p);
  }
  {
    RowTile<T, DH, BQ, NT> qt;
    qt.load(q + (((int64_t)b * Sq + q0) * Hq + h) * DH, (int64_t)Hq * DH, n_q);
    qt.store(Qs, LDQ);
  }
  __syncthreads();
  const int kv_end = min(kvl, qmax_s + 1);

  int my_pos[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][EPT];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    my_pos[i] = pos_s[ty * ROWS + i];
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = 0; t0 < kv_end; t0 += BK) {
    const int n_k = min(BK, kv_end - t0);
    const int64_t kv_off = (((int64_t)b * Skv + t0) * Hkv + hk) * DH;
    {
      RowTile<T, DH, BK, NT> kt, vt;
      kt.load(k + kv_off, (int64_t)Hkv * DH, n_k);
      vt.load(v + kv_off, (int64_t)Hkv * DH, n_k);
      kt.store(Ks, LDK);
      vt.store(Vs, LDV);
    }
    __syncthreads();

    // scores of this thread's ROWS x COLS block
    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < COLS; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float a[ROWS], bb[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) a[i] = Qs[(ty * ROWS + i) * LDQ + d];
#pragma unroll
      for (int c = 0; c < COLS; ++c) bb[c] = Ks[(tx + 16 * c) * LDK + d];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < COLS; ++c) s[i][c] = fmaf(a[i], bb[c], s[i][c]);
    }

    // scale, cap, mask; online softmax over the 16 threads sharing a row
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const int kp = t0 + tx + 16 * c;
        float x = s[i][c] * scale;
        if (cap > 0.f) x = cap * tanhf(x / cap);
        s[i][c] = (kp < kvl && kp <= my_pos[i]) ? x : REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        Ps[(ty * ROWS + i) * LDP + tx + 16 * c] = round_through<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < EPT; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // acc += P . V over the tile's valid rows
    for (int j = 0; j < n_k; ++j) {
      float vv[EPT];
#pragma unroll
      for (int e = 0; e < EPT; ++e) vv[e] = Vs[j * LDV + tx + 16 * e];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float p = Ps[(ty * ROWS + i) * LDP + j];
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = ty * ROWS + i;
    if (row < n_q) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* o = out + (((int64_t)b * Sq + q0 + row) * Hq + h) * DH;
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[tx + 16 * e] = from_f32<T>(acc[i][e] / denom);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* kv_len,
           void* out, int B, int Sq, int Skv, int Hq, int Hkv, float scale, float cap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  prefill_attention_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_len), static_cast<T*>(out), Sq,
      Skv, Hq, Hkv, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, const void* q_pos,
             const void* kv_len, void* out, int B, int Sq, int Skv, int Hq, int Hkv, float scale,
             float cap, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, stream);
    case 32: return launch<T, 32>(q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, stream);
    case 64: return launch<T, 64>(q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, stream);
    case 80: return launch<T, 80>(q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, stream);
    case 128: return launch<T, 128>(q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh), q_pos (B, Sq) int32, kv_len (B,)
// int32, out (B, Sq, Hq, Dh); all contiguous, on the stream's device.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_prefill_attention(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_len, void* out, int B,
                                       int Sq, int Skv, int Hq, int Hkv, int Dh, int dtype,
                                       float scale, float cap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(Dh, q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale, cap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, q_pos, kv_len, out, B, Sq, Skv, Hq, Hkv, scale,
                                   cap, s);
  return (int)cudaErrorInvalidValue;
}
