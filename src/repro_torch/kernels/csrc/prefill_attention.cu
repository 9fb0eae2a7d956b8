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
// the H100's ~295 operations per byte, so it is bound by operations: the
// bf16 tensor-core rate.
//
// Two kernels, chosen by dtype in the wrapper (a fixed route, not a
// fallback):
//
// bf16, the serving dtype: prefill_attention_wgmma. One block owns BQ = 128
// query rows of one (batch, KV head) as two warpgroups of 64 rows: the rows
// are (position, query head) pairs of the Hq / Hkv query heads that share
// the KV head, so each K/V tile is read once for all of them (at the
// llama3-8b chunk, 32 positions x 4 heads per block, 128 blocks). Both
// products run on wgmma with f32 accumulators in registers: S = Q.K^T with
// Q and K from shared memory, then O += P.V with P from registers (the
// scores' accumulator rounded to bf16, exactly where the reference rounds
// the probabilities before P.V, becomes the A operand in place) and V from
// shared memory read MN-major through the descriptor's transpose bit. The
// online softmax (running max m, sum l, rescale of O) runs on the
// accumulator fragments in registers, in base 2 (exp2f of scores scaled by
// log2 e). K/V tiles of BK = 64 rows (32 at Dh = 256, `bk_of`) arrive in
// bf16, unconverted, by 16-byte cp.async into a ring of STAGES = 4 slots
// (commit groups): two tiles load while two are read. At Dh = 256
// (gemma2) BK = 64 would need 320 KB of shared memory; BK = 32 needs
// 192 KB, and the O accumulator of 128 f32 registers per thread takes the
// m64n256k16 product, with S at m64n32k16. Every thread issues copies; the wgmma
// reads follow a proxy fence and one block barrier per tile. Inside a
// warpgroup, step t issues S of tile t + 1 and then P.V of tile t, waits
// for S only, and runs tile t + 1's softmax while the tensor cores run
// tile t's P.V. The operand layout has no swizzle (sm90.cuh), so every Dh
// in HEAD_DIMS, Dh = 80 included, takes the same code: no 128-byte swizzle
// atom, no 64 + 16 split. No TMA tensor map, so the build links nothing
// beyond the CUDA runtime. What the kernel still leaves on the table: the
// block barrier per tile keeps the two warpgroups in step (a producer warp
// with TMA and mbarriers would free them), and one block runs per SM.
//
// f32, the parity dtype: prefill_attention_f32, the first version's scalar
// kernel, kept because TF32 tensor cores cannot meet its 2e-5 tolerance.
// One block owns 64 query rows; products are f32 FMAs from f32 shared
// tiles. 256 threads as a 16 x 16 grid: thread (ty, tx) owns query rows
// 4 ty .. 4 ty + 3, score columns tx + 16 c, and output columns tx + 16 e.
// Q and K tiles have an odd row stride so that the 16 different K rows a
// half-warp reads fall in 16 different banks.
//
// Both kernels: the TPU kernel's sequential innermost grid axis over KV
// blocks becomes a loop inside the block, and it stops at min(kv_len, max
// q_pos of the block + 1): tiles past the causal edge or the valid prefix
// are never read. Masked scores take the reference's finite -0.7 * FLT_MAX
// (REPRO_NEG_INF). They mask the ragged edges themselves, so the wrapper
// pads nothing: query rows past Sq are never stored, and KV rows past the
// loop bound are zero-filled in shared memory, never read from the cache,
// so whatever the cache holds there (NaN included) cannot reach the output.
// The wgmma kernel masks only the tiles that cross the causal edge or
// kv_len, and a warpgroup skips tiles that none of its rows can see.

#include <climits>

#include "common.cuh"
#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ f32, scalar
namespace scalar {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // KV rows per tile
constexpr int NT = 256;       // threads per block
constexpr int ROWS = BQ / 16; // query rows per thread
constexpr int COLS = BK / 16; // score columns per thread

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <int DH>
__global__ void __launch_bounds__(NT)
prefill_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ q_pos,
                      const int* __restrict__ kv_len, float* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, float scale,
                      float cap) {
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
    RowTile<float, DH, BQ, NT> qt;
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
      RowTile<float, DH, BK, NT> kt, vt;
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
        Ps[(ty * ROWS + i) * LDP + tx + 16 * c] = p;
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
      float* o = out + (((int64_t)b * Sq + q0 + row) * Hq + h) * DH;
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[tx + 16 * e] = acc[i][e] / denom;
      if (lse != nullptr && tx == 0)
        lse[((int64_t)b * Hq + h) * Sq + q0 + row] = m[i] + logf(denom);
    }
  }
}


template <int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* kv_len,
           void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, float scale, float cap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_attention_f32<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  prefill_attention_f32<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_len), static_cast<float*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace scalar

// -------------------------------------------------------------- bf16, wgmma
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 2;         // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * WG;   // query rows per block
constexpr int STAGES = 4;     // K/V tiles in the ring
constexpr int NT = 128 * WG;  // threads per block
constexpr float LOG2E = 1.4426950408889634f;
static_assert(STAGES >= 3, "a step reads two tiles while the next one loads");

// KV rows per tile: 64, or 32 where 64 would not fit the ring in shared memory
template <int DH>
__host__ __device__ constexpr int bk_of() { return DH > 128 ? 32 : 64; }

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * (BQ * DH + STAGES * 2 * bk_of<DH>() * DH);
}
static_assert(smem_bytes<256>() <= 227 * 1024, "the ring fits the 227 KB a block may hold");

template <int DH>
__global__ void __launch_bounds__(NT, 1)
prefill_attention_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ kv_len, bf16* __restrict__ out,
                        float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, float scale,
                        float cap) {
  constexpr int BK = bk_of<DH>();
  constexpr int TILE = BK * DH;                // elements of one K or V tile
  constexpr uint32_t GROUP = DH / 8 * 128;     // bytes between 8-row groups of a tile
  constexpr int NS = BK / 8, NO = DH / 8;      // 8-column blocks of S and of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x DH
  bf16* KVs = Qs + BQ * DH;                      // slot s: K at 2 s TILE, V after it
  __shared__ int wg_min[WG], wg_max[WG];

  // The block's rows are (position, query head) pairs of one KV head,
  // flattened position-major: row R of (b, hk) is query head hk * qpk + R %
  // qpk at position R / qpk, so its q and out rows are contiguous runs of
  // qpk heads and every K/V tile serves all qpk query heads at once.
  const int qpk = Hq / Hkv;
  const int n_rt = (Sq * qpk + BQ - 1) / BQ;
  const int R0 = (n_rt - 1 - (int)blockIdx.x) * BQ;  // the longest row tiles start first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  // Values that steer wgmma are broadcast from lane 0 (warp_uniform), so the
  // compiler sees them uniform and keeps the products asynchronous (a branch
  // it must assume divergent serializes every wgmma).
  const int wg = warp_uniform(tid / 128), warp = (tid % 128) / 32, lane = tid % 32;
  const int n_q = min(BQ, Sq * qpk - R0);
  const int kvl = warp_uniform(min(kv_len[b], Skv));
  const int64_t kv_stride = (int64_t)Hkv * DH;
  const bf16* kb = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * DH;
  const bf16* vb = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * DH;
  // element offset of block row r in q and out
  auto row_off = [&](int r) {
    const int R = R0 + r;
    return ((int64_t)b * Sq + R / qpk) * Hq * DH + ((int64_t)hk * qpk + R % qpk) * DH;
  };

  if (tid < WG) {
    wg_min[tid] = INT_MAX;
    wg_max[tid] = -1;
  }
  load_tile<DH, BQ, NT>(Qs, n_q, [&](int r) { return q + row_off(r); });
  cp_async_commit();

  // this thread's accumulator rows: r0 and r0 + 8 of the block
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  int pos[2];
  int mn = INT_MAX, mx = -1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = r0 + 8 * r < n_q;
    pos[r] = valid ? q_pos[(int64_t)b * Sq + (R0 + r0 + 8 * r) / qpk] : INT_MAX;
    if (valid) {
      mn = min(mn, pos[r]);
      mx = max(mx, pos[r]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  __syncthreads();  // wg_min / wg_max initialised
  if (lane == 0) {
    atomicMin(&wg_min[wg], mn);
    atomicMax(&wg_max[wg], mx);
  }
  __syncthreads();
  int block_max = -1;
#pragma unroll
  for (int g = 0; g < WG; ++g) block_max = max(block_max, wg_max[g]);
  const int kv_end = warp_uniform(min(kvl, block_max + 1));  // the block reads no KV row past it
  const int wg_end = warp_uniform(min(kvl, wg_max[wg] + 1));  // no row of this warpgroup sees one
  const int wg_lo = warp_uniform(wg_min[wg]);  // ... and every row sees all columns <= wg_lo
  const int n_tiles = (kv_end + BK - 1) / BK;

  // this warpgroup computes tiles 0 .. n_wg - 1 (tiles of the block past them
  // hold only columns that none of its rows sees)
  const int n_wg = (wg_end + BK - 1) / BK;
  const float scale2 = scale * LOG2E;

  auto issue = [&](int t) {  // copies of tile t into its slot, as one commit group
    if (t < n_tiles) {
      const int t0 = t * BK, n_k = min(BK, kv_end - t0);
      bf16* slot = KVs + (t % STAGES) * 2 * TILE;
      load_tile<DH, BK, NT>(slot, n_k, [&](int r) { return kb + (t0 + r) * kv_stride; });
      load_tile<DH, BK, NT>(slot + TILE, n_k, [&](int r) { return vb + (t0 + r) * kv_stride; });
    }
    cp_async_commit();
  };
  // Operand descriptors, made once: a descriptor's start address counts
  // 16-byte units, so a step along a tile adds a constant to it.
  constexpr uint64_t SLOT = 2 * TILE * sizeof(bf16) / 16;  // one ring slot
  const uint64_t dq = wgmma_desc(Qs + wg * 64 * DH, 128, GROUP);
  const uint64_t dk = wgmma_desc(KVs, 128, GROUP);
  const uint64_t dv = wgmma_desc(KVs + TILE, GROUP, 128);
  // S = Q . K_t^T into s (issued, not committed)
  auto scores = [&](int t, float (&s)[BK / 2]) {
    const uint64_t dkt = dk + (t % STAGES) * SLOT;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)  // 16 columns: 2 core matrices, 256 bytes
      wgmma_ss(s, dq + 16 * kk, dkt + 16 * kk, kk > 0);
  };
  // O += P . V_t (issued, not committed)
  auto values = [&](int t, const uint32_t (&pa)[BK / 16][4], float (&o)[DH / 2]) {
    const uint64_t dvt = dv + (t % STAGES) * SLOT;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)  // 16 rows = 2 row groups
      wgmma_rs(o, pa[kk], dvt + 2 * kk * GROUP / 16, 1);
  };
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
  // Online softmax of tile t's scores s, in place: scale, cap, mask (only on
  // tiles that cross the causal edge or kv_len), in base 2; updates m and l
  // and returns in corr the factor O must be rescaled by. Rows r0 (e = 0, 1)
  // and r0 + 8 (e = 2, 3); a row's values lie in the 4 lanes that share
  // lane / 4.
  auto softmax = [&](int t, float (&s)[BK / 2], float (&corr)[2]) {
    const int t0 = t * BK;
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = cap * tanhf(s[i] * scale / cap) * LOG2E;
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= scale2;
    }
    if (t0 + BK > kvl || t0 + BK - 1 > wg_lo) {  // the tile crosses the causal edge or kv_len
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = t0 + 8 * i + 2 * (lane % 4) + (e & 1);
          if (!(col < kvl && col <= pos[e / 2])) s[4 * i + e] = REPRO_NEG_INF;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = m[r];
#pragma unroll
      for (int i = 0; i < NS; ++i) mt = fmaxf(mt, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      corr[r] = exp2f(m[r] - mt);
      m[r] = mt;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * i + 2 * r + e] - mt);
          s[4 * i + 2 * r + e] = p;
          sum += p;
        }
      }
      l[r] = l[r] * corr[r] + sum;  // this lane's share; the 4 lanes are summed at the end
    }
  };
  // P rounded to bf16 (as the reference rounds before P.V), in the A layout
  auto pack = [&](const float (&p)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16x2(p[8 * kk + 2 * j], p[8 * kk + 2 * j + 1]);
  };

  // Pipeline. Copies: tile t + STAGES - 1 is issued at step t, into the slot
  // of tile t - 1, whose last reader (P.V of step t - 1) the barrier of step
  // t has seen finish. Products: step t issues S of tile t + 1 and then P.V
  // of tile t, waits for the first only, and runs tile t + 1's softmax on
  // the ALUs while the tensor cores run tile t's P.V; only then are O
  // rescaled and P packed into the A registers (no register a product in
  // flight reads is written before its wait, or ptxas serializes them).
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float s[BK / 2], corr[2];
  uint32_t pa[BK / 16][4];
  cp_async_wait<STAGES - 2>();  // this thread's copies of Q and tile 0 have landed
  fence_proxy_async();
  __syncthreads();  // everyone's have
  if (n_wg > 0) {
    fence_regs(s);
    wgmma_fence();
    scores(0, s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0, s, corr);  // O is 0: nothing to rescale
    pack(s, pa);
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 3>();  // this thread's copies of tile t + 1 have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; every read of tile t - 1's slot is done
    issue(t + STAGES - 1);
    if (t >= n_wg) continue;  // uniform over the warpgroup
    fence_regs(s);  // every register the products read is written before they start
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    if (t + 1 < n_wg) {
      scores(t + 1, s);
      wgmma_commit();
      values(t, pa, o);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile t + 1 is in; P.V of tile t may still run
      fence_regs(s);
      softmax(t + 1, s, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        o[4 * i + 0] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      pack(s, pa);
    } else {
      values(t, pa, o);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block (the ring's last groups are empty)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + 8 * r;
    if (row < n_q) {
      const float denom = fmaxf(l[r], 1e-30f);
      bf16* dst = out + row_off(row) + 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < NO; ++i)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
            __floats2bfloat162_rn(o[4 * i + 2 * r] / denom, o[4 * i + 2 * r + 1] / denom);
      if (lse != nullptr && lane % 4 == 0) {  // m is in base 2: lse = (m + log2 l) ln 2
        const int R = R0 + row;
        lse[((int64_t)b * Hq + (int64_t)hk * qpk + R % qpk) * Sq + R / qpk] =
            (m[r] + log2f(denom)) * 0.6931471805599453f;
      }
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* q_pos, const void* kv_len,
           void* out, void* lse, int B, int Sq, int Skv, int Hq, int Hkv, float scale, float cap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(prefill_attention_wgmma<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((Sq * (Hq / Hkv) + BQ - 1) / BQ, Hkv, B);
  prefill_attention_wgmma<DH><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_len), static_cast<bf16*>(out),
      static_cast<float*>(lse), Sq, Skv, Hq, Hkv, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh), q_pos (B, Sq) int32, kv_len (B,)
// int32, out (B, Sq, Hq, Dh); all contiguous, on the stream's device; Dh in
// {16, 32, 64, 80, 128, 256}. lse, when not null, receives each query row's
// log-sum-exp of its masked, capped scores, (B, Hq, Sq) f32 in natural log:
// what the backward kernels (prefill_attention_bwd.cu) recompute P from; the
// serving path passes null. Each returns the launch's cudaError_t.
extern "C" int repro_prefill_attention_f32(const void* q, const void* k, const void* v,
                                           const void* q_pos, const void* kv_len, void* out,
                                           void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
                                           float scale, float cap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(Dh, [&](auto dh) {
    return scalar::launch<decltype(dh)::value>(q, k, v, q_pos, kv_len, out, lse, B, Sq, Skv, Hq, Hkv,
                                               scale, cap, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int repro_prefill_attention_bf16(const void* q, const void* k, const void* v,
                                            const void* q_pos, const void* kv_len, void* out,
                                            void* lse, int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
                                            float scale, float cap, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return with_head_dim(Dh, [&](auto dh) {
    return tc::launch<decltype(dh)::value>(q, k, v, q_pos, kv_len, out, lse, B, Sq, Skv, Hq, Hkv, scale,
                                           cap, static_cast<cudaStream_t>(stream));
  });
}
