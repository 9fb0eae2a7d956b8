// GQA flash decode for Hopper: one query token per sequence over its KV cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (flash_decode_attention, body _decode_kernel): out[b, h] attends over the
// rows j < kv_len[b] of KV head h / (Hq / Hkv), softmax in f32, optional
// tanh logit cap.
//
// What bounds it on the card: each KV element is read once and used for
// qpk = Hq / Hkv query heads (4 for llama3-8b, 1 for zamba2), about 2 * qpk
// operations per element, far below the H100's ~295 operations per byte,
// so it is bound by bytes: 2 * kv_len * Hkv * Dh elements per sequence. To
// come near that the card needs many tiles in flight on every SM.
//
// Design: split-KV in two kernels, launched one after the other on the
// stream by the one C entry point.
//
// 1. decode_split. The KV axis is cut into splits of SPLIT = 256 rows, a
//    fixed length that depends on nothing else (not on B, S or the batch's
//    other rows). One block owns one (batch, KV head, split) and its qpk
//    query heads, so K and V are read from device memory once per group,
//    the grouping of the TPU kernel's (qpk, Dh) x (Dh, bk) product. The grid
//    has ceil(S / SPLIT) splits per (batch, KV head); a split at or past
//    kv_len returns at once, so the work is sum ceil(kv_len / SPLIT) * Hkv
//    blocks (264 at the llama3-8b serving shape, against the B * Hkv = 64
//    of the first version). Inside a split, tiles of BK = 32 rows arrive in
//    their own dtype, unconverted, by 16-byte cp.async into a ring of
//    STAGES = 4 slots (commit groups): three tiles load while one
//    computes. In f32 at Dh = 256 four slots would take 282 KB of shared
//    memory, so that kernel keeps three (216 KB; `stages`). Rows past kv_len in the last tile are zero-filled, never
//    read. Products are f32 FMAs on operands read from shared memory as
//    packed pairs (bf16x2 or float2) or 16-byte vectors. Not mma.sync: the
//    product is 2 * qpk operations per element, which the FMA units do
//    well under the time the bytes take (about 5 us of SM time at the llama
//    shape, against a byte bound of 10 us), while m16n8k16 would pad the
//    qpk <= 16 query heads to 16 rows and cannot serve f32 at its 2e-5
//    tolerance; one design serves both dtypes. Scores: two threads per
//    (query head, row), each over alternate 16-byte chunks, with a row
//    stride of 8 (mod 32) words so that a quarter-warp's 8 reads hit 8
//    distinct bank groups. Each warp runs the online softmax of its query
//    heads; probabilities are rounded to the value dtype before P.V, as the
//    reference does. The block writes its f32 partial (running max m, sum
//    l, unnormalised accumulator) to scratch that the wrapper allocates.
// 2. decode_combine. One block per (batch, query head) merges the splits
//    below kv_len in split order (rescaling by exp(m_s - max m)), so the
//    result is deterministic, and writes out in the output dtype.
//
// A sequence's output therefore depends only on its own q and its K/V rows
// below kv_len: not on its batch-mates, not on S, not on slot or paged
// layout, and it is bit-identical whatever the cache holds past kv_len
// (NaN included). Masked scores take the reference's finite -0.7 * FLT_MAX
// (REPRO_NEG_INF); a masked score adds exactly 0 once the running max is
// finite, which the first row of every split makes it.

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int SPLIT = 256;   // KV rows per split (ops.py's SPLIT_ROWS)
constexpr int BK = 32;       // KV rows per tile
constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int QMAX = 16;     // most query heads per KV head
constexpr int LDP = BK + 1;  // row stride of the score tile
constexpr int COMBINE_NT = 128;
static_assert(BK == 32, "the softmax gives one score of a tile to each lane");

// Shared layout of one K or V tile of BK rows in dtype T: 16-byte chunks,
// rows LD elements apart with LD * sizeof(T) / 4 = 8 (mod 32).
template <typename T, int DH>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CPR = DH / VEC;         // chunks per row, even for every HEAD_DIMS
  static constexpr int WORDS = DH * (int)sizeof(T) / 4;
  static constexpr int LD = (WORDS + (40 - WORDS % 32) % 32) * 4 / (int)sizeof(T);
  static constexpr int ELEMS = BK * LD;
  static_assert(CPR % 2 == 0, "two threads share a row's chunks");
};

// tiles in the ring: 4, or 3 where a row takes more than 512 bytes (f32 at Dh = 256)
template <typename T, int DH>
__host__ __device__ constexpr int stages() { return sizeof(T) * DH > 512 ? 3 : 4; }

template <typename T, int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (QMAX * DH + QMAX * LDP) +
         sizeof(T) * stages<T, DH>() * 2 * Tile<T, DH>::ELEMS;
}
static_assert(smem_bytes<float, 256>() <= 227 * 1024, "the ring fits the 227 KB a block may hold");

__device__ __forceinline__ float2 to_f32x2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 to_f32x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
decode_split(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kv_len, float* __restrict__ part_o,
             float* __restrict__ part_ml, int S, int Hq, int Hkv, float scale, float cap) {
  using L = Tile<T, DH>;
  constexpr int STAGES = stages<T, DH>();
  constexpr int NPAIR = DH / 2;                          // column pairs of a head
  constexpr int NE = (QMAX * NPAIR + NT - 1) / NT;       // accumulator pairs per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);        // QMAX x DH
  float* Ps = Qs + QMAX * DH;                            // QMAX x LDP: scores, then probabilities
  T* ring = reinterpret_cast<T*>(Ps + QMAX * LDP);       // slot s: K at 2 s ELEMS, V after it
  __shared__ float corr_s[QMAX];

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int kvl = min(kv_len[b], S);
  const int j0 = split * SPLIT;
  if (j0 >= kvl) return;  // nothing of this sequence lies in the split
  const int j1 = min(kvl, j0 + SPLIT);
  const int n_tiles = (j1 - j0 + BK - 1) / BK;
  const int qpk = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t kv_stride = (int64_t)Hkv * DH;
  const T* kb = k + ((int64_t)b * S + j0) * kv_stride + (int64_t)hk * DH;
  const T* vb = v + ((int64_t)b * S + j0) * kv_stride + (int64_t)hk * DH;

  auto issue = [&](int t) {  // copies of tile t into its slot, as one commit group
    if (t < n_tiles) {
      const int r0 = t * BK, n_k = min(BK, j1 - j0 - r0);
      T* slot = ring + (t % STAGES) * 2 * L::ELEMS;
      for (int i = tid; i < 2 * BK * L::CPR; i += NT) {
        const int kv = i / (BK * L::CPR), r = (i / L::CPR) % BK, c = i % L::CPR;
        const bool ok = r < n_k;
        const T* src = (kv ? vb : kb) + (int64_t)(r0 + (ok ? r : 0)) * kv_stride + c * L::VEC;
        cp_async_16(slot + kv * L::ELEMS + r * L::LD + c * L::VEC, src, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  const T* qb = q + ((int64_t)b * Hq + (int64_t)hk * qpk) * DH;
  for (int i = tid; i < qpk * DH; i += NT) Qs[i] = to_f32(qb[i]);

  // softmax state of query head g = warp + NW i, held by every lane of that warp
  float m_r[QMAX / NW], l_r[QMAX / NW];
#pragma unroll
  for (int i = 0; i < QMAX / NW; ++i) {
    m_r[i] = REPRO_NEG_INF;
    l_r[i] = 0.f;
  }
  float acc[NE][2];
#pragma unroll
  for (int e = 0; e < NE; ++e) acc[e][0] = acc[e][1] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    issue(t + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's have (and Qs is written)
    const T* Ks = ring + (t % STAGES) * 2 * L::ELEMS;
    const T* Vs = Ks + L::ELEMS;
    const int n_k = min(BK, j1 - j0 - t * BK);

    // scores: threads 2 p and 2 p + 1 share (query head, row) p over alternate chunks
    for (int i = tid; i < qpk * BK * 2; i += NT) {  // whole warps: qpk * BK * 2 is a multiple of 64
      const int half = i & 1, g = (i >> 1) / BK, j = (i >> 1) % BK;
      const T* kr = Ks + j * L::LD;
      const float* qr = Qs + g * DH;
      float s = 0.f;
#pragma unroll
      for (int c = half; c < L::CPR; c += 2) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c * L::VEC);
        const T* kv = reinterpret_cast<const T*>(&raw);
        const float4* q4 = reinterpret_cast<const float4*>(qr + c * L::VEC);
#pragma unroll
        for (int e = 0; e < L::VEC; e += 4) {
          const float4 qv = q4[e / 4];
          const float2 k01 = to_f32x2(kv + e), k23 = to_f32x2(kv + e + 2);
          s = fmaf(qv.x, k01.x, s);
          s = fmaf(qv.y, k01.y, s);
          s = fmaf(qv.z, k23.x, s);
          s = fmaf(qv.w, k23.y, s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (half == 0) {
        s *= scale;
        if (cap > 0.f) s = cap * tanhf(s / cap);
        Ps[g * LDP + j] = j < n_k ? s : REPRO_NEG_INF;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < QMAX / NW; ++i) {
      const int g = warp + NW * i;
      if (g < qpk) {  // uniform across the warp
        const float s = Ps[g * LDP + lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_r[i], mx);
        const float corr = expf(m_r[i] - m_new);
        const float p = expf(s - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l_r[i] = l_r[i] * corr + sum;
        m_r[i] = m_new;
        Ps[g * LDP + lane] = round_through<T>(p);
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int idx = tid + e * NT;
      const int g = idx / NPAIR, d = 2 * (idx % NPAIR);
      if (g < qpk) {
        const float c = corr_s[g];
        float a0 = acc[e][0] * c, a1 = acc[e][1] * c;
        for (int j = 0; j < n_k; ++j) {
          const float p = Ps[g * LDP + j];
          const float2 vf = to_f32x2(Vs + j * L::LD + d);
          a0 = fmaf(p, vf.x, a0);
          a1 = fmaf(p, vf.y, a1);
        }
        acc[e][0] = a0;
        acc[e][1] = a1;
      }
    }
    __syncthreads();  // the slot of tile t is free to refill
  }
  cp_async_wait<0>();  // no copy outlives the block (the ring's last groups are empty)

  // partials of query head hq = hk * qpk + g at [(b * Hq + hq) * n_split + split]
  const int64_t row0 = ((int64_t)b * Hq + (int64_t)hk * qpk) * n_split + split;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const int idx = tid + e * NT;
    const int g = idx / NPAIR, d = 2 * (idx % NPAIR);
    if (g < qpk)
      *reinterpret_cast<float2*>(part_o + (row0 + (int64_t)g * n_split) * DH + d) =
          make_float2(acc[e][0], acc[e][1]);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < QMAX / NW; ++i) {
      const int g = warp + NW * i;
      if (g < qpk)
        *reinterpret_cast<float2*>(part_ml + (row0 + (int64_t)g * n_split) * 2) =
            make_float2(m_r[i], l_r[i]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_NT)
decode_combine(const float* __restrict__ part_o, const float* __restrict__ part_ml,
               const int* __restrict__ kv_len, T* __restrict__ out, int S, int Hq, int Dh,
               int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int ns = (min(kv_len[b], S) + SPLIT - 1) / SPLIT;  // splits below kv_len
  const int64_t row0 = ((int64_t)b * Hq + h) * n_split;
  float m = REPRO_NEG_INF;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, part_ml[(row0 + s) * 2]);
  float l = 0.f;
  for (int s = 0; s < ns; ++s) l += part_ml[(row0 + s) * 2 + 1] * expf(part_ml[(row0 + s) * 2] - m);
  const float inv_l = 1.f / fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < Dh; d += COMBINE_NT) {
    float o = 0.f;
    for (int s = 0; s < ns; ++s) o += part_o[(row0 + s) * Dh + d] * expf(part_ml[(row0 + s) * 2] - m);
    out[((int64_t)b * Hq + h) * Dh + d] = from_f32<T>(o * inv_l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* out,
           float* part_o, float* part_ml, int B, int S, int Hq, int Hkv, int n_split, float scale,
           float cap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(decode_split<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  decode_split<T, DH><<<dim3(n_split, Hkv, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), part_o, part_ml, S, Hq, Hkv, scale, cap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine<T><<<dim3(Hq, B), COMBINE_NT, 0, stream>>>(
      part_o, part_ml, static_cast<const int*>(kv_len), static_cast<T*>(out), S, Hq, DH, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Hq, Dh), k/v (B, S, Hkv, Dh), kv_len (B,) int32 with 1 <= kv_len,
// out (B, Hq, Dh); scratch part_o (B, Hq, n_split, Dh) and part_ml (B, Hq,
// n_split, 2) in f32 with n_split = ceil(S / 256); all contiguous, on the
// stream's device. Hq / Hkv <= 16. dtype: 0 = float32, 1 = bfloat16.
// Launches the split kernel and the combine kernel; returns the first
// launch error (a cudaError_t), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, void* part_o, void* part_ml,
                                      int B, int S, int Hq, int Hkv, int Dh, int n_split,
                                      int dtype, float scale, float cap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > QMAX || n_split != (S + SPLIT - 1) / SPLIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  return with_head_dim(Dh, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    if (dtype == 0)
      return launch<float, DH>(q, k, v, kv_len, out, po, pml, B, S, Hq, Hkv, n_split, scale, cap, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, DH>(q, k, v, kv_len, out, po, pml, B, S, Hq, Hkv, n_split, scale,
                                       cap, s);
    return (int)cudaErrorInvalidValue;
  });
}
