// GQA flash decode for Hopper: one query token per sequence over its KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (flash_decode_attention, body _decode_kernel): out[b, h] attends over the
// rows j < kv_len[b] of KV head h / (Hq / Hkv), softmax in f32, optional
// tanh logit cap.
//
// What bounds it on the card: each KV element is read once and used for
// qpk = Hq / Hkv query heads (4 for llama3-8b), about 2 * qpk operations
// per element, far below the H100's ~295 operations per byte, so it is
// bound by bytes: 2 * kv_len * Hkv * Dh elements per sequence.
//
// Design. One block owns one (batch, KV head) and its qpk query heads, so
// K and V are read from device memory once per group, the same grouping as
// the TPU kernel's (qpk, Dh) x (Dh, bk) product. The TPU's sequential KV
// grid axis becomes a loop inside the block that stops at kv_len: tiles
// past the valid length are never read, and rows past it inside the last
// tile are zero-filled, not loaded. That is the same math as the masked
// reference, because a masked score adds exactly 0 once the running max is
// finite, and it makes the output independent of whatever the cache holds
// past kv_len (bit for bit). Scores are kept in f32 with the reference's
// finite -0.7 * FLT_MAX mask value; each warp runs the online softmax of
// its query heads, and every thread owns fixed (head, column) entries of
// the f32 accumulator. This first version reads each tile synchronously
// and, at B * Hkv blocks, leaves SMs idle when the batch is small; splitting
// the KV axis across blocks and overlapping loads are for a later PR.

#include "common.cuh"

namespace {

constexpr int BK = 64;    // KV rows per tile
constexpr int NT = 256;   // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int QMAX = 16;  // most query heads per KV head

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (QMAX * DH + BK * (DH + 1) + BK * DH + QMAX * (BK + 1));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ kv_len,
                        T* __restrict__ out, int S, int Hq, int Hkv, float scale, float cap) {
  constexpr int LDK = DH + 1, LDV = DH, LDP = BK + 1;
  constexpr int NE = QMAX * DH / NT;  // accumulator entries per thread
  constexpr int GL = NT / BK;         // query-head lanes in the score pass
  extern __shared__ float smem[];
  float* Qs = smem;               // QMAX x DH
  float* Ks = Qs + QMAX * DH;     // BK x LDK
  float* Vs = Ks + BK * LDK;      // BK x LDV
  float* Ps = Vs + BK * LDV;      // QMAX x LDP: scores, then probabilities
  __shared__ float corr_s[QMAX];
  __shared__ float l_s[QMAX];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kvl = min(kv_len[b], S);

  {
    RowTile<T, DH, QMAX, NT> qt;
    qt.load(q + ((int64_t)b * Hq + (int64_t)hk * qpk) * DH, DH, qpk);
    qt.store(Qs, DH);
  }

  // softmax state of query head g = warp + NW i, held by every lane of that warp
  float m_r[QMAX / NW], l_r[QMAX / NW];
#pragma unroll
  for (int i = 0; i < QMAX / NW; ++i) {
    m_r[i] = REPRO_NEG_INF;
    l_r[i] = 0.f;
  }
  float acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e] = 0.f;

  const int js = tid % BK, gl = tid / BK;
  for (int t0 = 0; t0 < kvl; t0 += BK) {
    const int n_k = min(BK, kvl - t0);
    const int64_t kv_off = (((int64_t)b * S + t0) * Hkv + hk) * DH;
    {
      RowTile<T, DH, BK, NT> kt, vt;
      kt.load(k + kv_off, (int64_t)Hkv * DH, n_k);
      vt.load(v + kv_off, (int64_t)Hkv * DH, n_k);
      kt.store(Ks, LDK);
      vt.store(Vs, LDV);
    }
    __syncthreads();

    for (int g = gl; g < qpk; g += GL) {
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(Qs[g * DH + d], Ks[js * LDK + d], s);
      s *= scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      Ps[g * LDP + js] = js < n_k ? s : REPRO_NEG_INF;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < QMAX / NW; ++i) {
      const int g = warp + NW * i;
      if (g < qpk) {  // uniform across the warp
        const float s0 = Ps[g * LDP + lane], s1 = Ps[g * LDP + lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_r[i], mx);
        const float corr = expf(m_r[i] - m_new);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_r[i] = l_r[i] * corr + sum;
        m_r[i] = m_new;
        Ps[g * LDP + lane] = round_through<T>(p0);
        Ps[g * LDP + lane + 32] = round_through<T>(p1);
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int idx = tid + e * NT;
      const int g = idx / DH, d = idx % DH;
      if (g < qpk) {
        float a = acc[e] * corr_s[g];
        for (int j = 0; j < n_k; ++j) a = fmaf(Ps[g * LDP + j], Vs[j * LDV + d], a);
        acc[e] = a;
      }
    }
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < QMAX / NW; ++i) {
      const int g = warp + NW * i;
      if (g < qpk) l_s[g] = l_r[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int idx = tid + e * NT;
    const int g = idx / DH, d = idx % DH;
    if (g < qpk)
      out[((int64_t)b * Hq + (int64_t)hk * qpk + g) * DH + d] =
          from_f32<T>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out, int B,
           int S, int Hq, int Hkv, float scale, float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_attention_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(Hkv, B);
  decode_attention_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(out), S, Hq, Hkv, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int Dh, const void* q, const void* k, const void* v, const void* kv_len, void* out,
             int B, int S, int Hq, int Hkv, float scale, float cap, cudaStream_t stream) {
  switch (Dh) {
    case 16: return launch<T, 16>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, stream);
    case 32: return launch<T, 32>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, stream);
    case 64: return launch<T, 64>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, stream);
    case 80: return launch<T, 80>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, stream);
    case 128: return launch<T, 128>(q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Dh), k/v (B, S, Hkv, Dh), kv_len (B,) int32 with 1 <= kv_len,
// out (B, Hq, Dh); all contiguous, on the stream's device. Hq / Hkv <= 16.
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, int B, int S, int Hq,
                                      int Hkv, int Dh, int dtype, float scale, float cap,
                                      void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > QMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(Dh, q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(Dh, q, k, v, kv_len, out, B, S, Hq, Hkv, scale, cap, s);
  return (int)cudaErrorInvalidValue;
}
