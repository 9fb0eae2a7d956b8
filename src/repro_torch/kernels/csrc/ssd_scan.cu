// Mamba2 SSD chunked scan (state-space duality, G groups of B and C) for
// Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (ssd_scan,
// body _ssd_kernel), whose oracle is src/repro/models/ssm.py::ssd_chunked.
// Per (batch b, head h) the sequence runs in chunks of Q rows. With
// dA = dt * A and cums its inclusive cumsum within the chunk:
//   y[i]    = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//             + exp(cums_i) (C_i . state)                         (P values)
//   state' = state exp(cums_last) + sum_t exp(cums_last - cums_t) dt_t x_t B_t^T
// B and C come in G groups (B, L, G, N): head h reads group h / (H / G), as
// the reference's jnp.repeat of the groups over the heads; a row of B or C
// is G N elements, group g at offset g N. G = 1 shares one group across
// every head.
//
// What bounds the function on the card: per (b, h, chunk) the work is
// 2 Q^2 N (C B^T) + 2 Q^2 P (scores . x dt) + 4 Q N P (C state^T, state
// increment) operations, against x and y read and written once and B, C
// and dt read once (B and C once per group). At zamba2-2.7b's serving shapes (Q = 128,
// P = N = 64, bf16) that is about 190 operations per byte, below the H100's
// ~295: the function is bound by bytes (x, y, B, C, dt and the final state:
// ~89 MB at B = 2, L = 2048, H = 80, 0.027 ms at 3.35 TB/s).
//
// Two routes, chosen before any launch by dtype and shape
// (ssd_scan/ops.py::route, a fixed choice and never a fallback):
//
// bf16 at Q in {64, 128}, P in {32, 64}, N in {32, 64, 128}: the tensor-core
// route, two kernels on the stream, with f32 scratch S_in (B, NC, H, P, N)
// from the wrapper: the state at every chunk start. The design's byte floor
// is the function's plus one write and one read of S_in (42 MB at zamba2
// B = 2, 84 MB at B = 4, 25 MB at mamba2-130m B = 2; ~173 MB in all at
// zamba2 B = 2, 0.052 ms). Of the operations only the recurrence's state
// increment, 2 Q N P of 2 Q^2 (N + P) + 4 Q N P per chunk (a sixth at
// Q = 128, P = N = 64), is sequential over chunks.
//   ssd_state_pass, grid (H, B), one warpgroup per (b, h): the carried
//   (P, N) state lives in f32 wgmma accumulators (rows p, 64 per product:
//   at P = 32 the upper 32 rows are zero). Per chunk, in order, it stores
//   the state to S_in, scales it by exp(cums_last) and accumulates
//   (x exp(cums_last - cums_t) dt_t)^T . B_c with wgmma (M = P, N = N,
//   K = Q): the scaled x is the register A operand, read transposed out of
//   shared memory by ldmatrix.trans and rounded to bf16 once; B_c is read
//   MN-major through the transpose bit. The state itself is never rounded.
//   x, B and dt of the next chunk arrive by cp.async while the current one
//   computes (a ring of two chunks), and shared memory (67 KiB at N = 64,
//   99 KiB at N = 128) leaves room for three or two blocks per SM. Every
//   warp scans the chunk's dA itself, so no block barrier guards the scan.
//   ssd_chunk_out, grid (G ceil(rep / HG), NC, B) with rep = H / G heads
//   per group, Q / 64 warpgroups of 64 rows: every chunk at once. The
//   scores C_c . B_c^T (both K-major over N, as S = Q.K^T in
//   prefill_attention.cu) are computed once into f32 registers and reused
//   for the block's HG heads, so a block's heads lie in one group: each
//   group's rep heads are cut into blocks of HG, the last one partial
//   (rep = 3 at HG = 2: 2 + 1); a warpgroup computes only the 64-column
//   blocks its rows can see. Per
//   head: y = C . S_in^T first (S_in rounded to bf16 into shared memory,
//   not a TF32 product: C stays bf16, both operands K-major, and the error
//   stays inside the route's limit), its rows scaled by exp(cums_i) in
//   registers, then P . x accumulated into the same registers, with
//   P[i, j] = G[i, j] exp(cums_i - cums_j) dt_j rounded to bf16 in
//   registers as the A operand and x MN-major through the transpose bit,
//   as P.V in prefill_attention.cu. The exp is evaluated only where j <= i
//   (a select, never a multiplied mask: above the diagonal it overflows and
//   inf * 0 is NaN), and never factored as exp(cums_i) exp(-cums_j), which
//   overflows late in a chunk. x tiles of the next heads arrive by cp.async
//   into a ring of three, and the next head's S_in tile is read into
//   registers while the current head computes. HG is 8, halved while the
//   grid would not fill the SMs (HG = 8 at zamba2 B = 2: 320 blocks; 4 at
//   mamba2 B = 2: 192 blocks), then at most rep; ops.py::_head_group is the
//   same rule for the backward's blocks.
//   What holds the route back (PERF.md): the loads and stores themselves,
//   not the products. On an H100 most of the state pass's time goes to
//   issuing its 16-byte cp.async copies; deeper rings, more blocks per SM
//   and splitting the state's columns over blocks did not help. TMA tiles
//   behind mbarriers, and S_in in bf16 (it is rounded to bf16 before use
//   anyway), are the next step.
//
// Everything else, and all of f32 (held to 1e-4, which bf16 tensor cores
// cannot meet), runs the first version's scalar kernel, ssd_scan_kernel:
// one block owns one (b, h) and loops over the chunks in order, carrying
// the (P, N) f32 state in shared memory, with the products as f32 FMAs
// from f32 shared tiles; it reads its head's group of B and C once per
// head and runs B * H blocks. The intra-chunk product runs RB = 32 query rows at a time over
// a 32 x Q score tile, only over the columns j < the tile's last row + 1.
// 256 threads as a 16 x 16 grid (ty, tx): score columns tx + 16 c, output
// columns tx + 16 e, state entries (ty * P/16 + i, tx + 16 c). Tiles have
// an odd row stride so that the 16 rows a half-warp reads fall in 16
// different banks. Under grad (ssd_scan/ops.py::SSDScanFn) it also writes
// the state at every chunk start to S_in, which the backward reads
// (ssd_scan_bwd.cu); the serving path passes no S_in.
//
// Both routes: the TPU kernel's sequential chunk grid axis and its VMEM
// state scratch become a loop over chunks inside a block. Rows past L are
// zero-filled (never read), and dt there is 0, so they reach neither y nor
// the state; y rows past L are not written; cums_last is that of the last
// valid row.

#include "common.cuh"
#include "sm90.cuh"
#include "ssd_tc.cuh"

namespace {

constexpr int QMAX = 128;  // most rows in one chunk
constexpr int RB = 32;     // query rows per pass of the intra-chunk product
constexpr int NT = 256;    // threads per block

template <int P, int N>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * QMAX * (N + 1) + QMAX * (P + 1) + P * (N + 1) + RB * (QMAX + 1) + 3 * QMAX);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ init_state,
                T* __restrict__ y, float* __restrict__ final_state, float* __restrict__ s_in,
                int L, int H, int G, int Q) {
  constexpr int LDN = N + 1, LDP = P + 1, LDS = QMAX + 1;
  constexpr int RPT = RB / 16;    // score and output rows per thread
  constexpr int CPT = QMAX / 16;  // score column groups
  constexpr int PPT = P / 16;     // output columns per thread
  constexpr int NPT = N / 16;     // state columns per thread (rows: PPT)
  extern __shared__ float smem[];
  float* Cs = smem;              // QMAX x LDN
  float* Bs = Cs + QMAX * LDN;   // QMAX x LDN
  float* Xs = Bs + QMAX * LDN;   // QMAX x LDP: x, then x * dt
  float* Ss = Xs + QMAX * LDP;   // P x LDN: the carried state
  float* Sc = Ss + P * LDN;      // RB x LDS: masked, decayed scores
  float* cum = Sc + RB * LDS;    // QMAX: cumsum of dA
  float* dts = cum + QMAX;       // QMAX: dt
  float* wts = dts + QMAX;       // QMAX: exp(cums_last - cums_t)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];
  const int64_t state_off = ((int64_t)b * H + h) * P * N;
  const int grp = h / (H / G);  // the group of B and C this head reads

  for (int i = tid; i < P * N; i += NT)
    Ss[(i / N) * LDN + i % N] = init_state != nullptr ? init_state[state_off + i] : 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    const int nq = min(Q, L - l0);
    if (s_in != nullptr) {  // the state at the chunk's start, for the backward
      float* so = s_in + (((int64_t)b * ((L + Q - 1) / Q) + l0 / Q) * H + h) * P * N;
      for (int i = tid; i < P * N; i += NT) so[i] = Ss[(i / N) * LDN + i % N];
    }
    {
      RowTile<T, P, QMAX, NT> xt;
      xt.load(x + (((int64_t)b * L + l0) * H + h) * P, (int64_t)H * P, nq);
      xt.store(Xs, LDP);
    }
    {
      RowTile<T, N, QMAX, NT> bt;
      bt.load(Bm + (((int64_t)b * L + l0) * G + grp) * N, (int64_t)G * N, nq);
      bt.store(Bs, LDN);
    }
    {
      RowTile<T, N, QMAX, NT> ct;
      ct.load(Cm + (((int64_t)b * L + l0) * G + grp) * N, (int64_t)G * N, nq);
      ct.store(Cs, LDN);
    }
    if (tid < QMAX) dts[tid] = tid < nq ? dt[((int64_t)b * L + l0 + tid) * H + h] : 0.f;
    __syncthreads();

    // x -> x * dt; warp 0: inclusive cumsum of dA over the chunk
    for (int i = tid; i < nq * P; i += NT) Xs[(i / P) * LDP + i % P] *= dts[i / P];
    if (tid < 32) {
      constexpr int PER = QMAX / 32;
      float part[PER], run = 0.f;
#pragma unroll
      for (int k = 0; k < PER; ++k) {
        run += dts[tid * PER + k] * a;
        part[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += t;
      }
#pragma unroll
      for (int k = 0; k < PER; ++k) cum[tid * PER + k] = incl - run + part[k];
    }
    __syncthreads();

    const float c_last = cum[nq - 1];
    if (tid < QMAX) wts[tid] = tid < nq ? expf(c_last - cum[tid]) : 0.f;

    for (int r0 = 0; r0 < nq; r0 += RB) {
      const int jmax = min(r0 + RB, nq);  // columns any row of this pass can see
      const int ncg = (jmax + 15) / 16;
      // scores C_i . B_j of rows r0 + ty * RPT + i, columns tx + 16 c
      float s[RPT][CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[i][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cr[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cr[i] = Cs[(r0 + ty * RPT + i) * LDN + n];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          if (c < ncg) {
            const float bv = Bs[(tx + 16 * c) * LDN + n];
#pragma unroll
            for (int i = 0; i < RPT; ++i) s[i][c] = fmaf(cr[i], bv, s[i][c]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = r0 + ty * RPT + i;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tx + 16 * c;
          if (c < ncg) {
            float v = 0.f;
            if (col <= row && row < nq) v = s[i][c] * expf(cum[row] - cum[col]);
            Sc[(ty * RPT + i) * LDS + col] = v;
          }
        }
      }
      __syncthreads();

      // y = scores . (x dt) + exp(cums) (C . state^T), rows r0 + ty * RPT + i,
      // columns tx + 16 e
      float acc[RPT][PPT], off[RPT][PPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int e = 0; e < PPT; ++e) acc[i][e] = off[i][e] = 0.f;
      for (int j = 0; j < jmax; ++j) {
        float xv[PPT];
#pragma unroll
        for (int e = 0; e < PPT; ++e) xv[e] = Xs[j * LDP + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float sv = Sc[(ty * RPT + i) * LDS + j];
#pragma unroll
          for (int e = 0; e < PPT; ++e) acc[i][e] = fmaf(sv, xv[e], acc[i][e]);
        }
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cr[RPT], sv[PPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) cr[i] = Cs[(r0 + ty * RPT + i) * LDN + n];
#pragma unroll
        for (int e = 0; e < PPT; ++e) sv[e] = Ss[(tx + 16 * e) * LDN + n];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < PPT; ++e) off[i][e] = fmaf(cr[i], sv[e], off[i][e]);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = r0 + ty * RPT + i;
        if (row < nq) {
          const float dec = expf(cum[row]);
          T* yo = y + (((int64_t)b * L + l0 + row) * H + h) * P;
#pragma unroll
          for (int e = 0; e < PPT; ++e)
            yo[tx + 16 * e] = from_f32<T>(acc[i][e] + dec * off[i][e]);
        }
      }
      __syncthreads();  // the next pass overwrites Sc; the state update below writes Ss
    }

    // state = state * exp(cums_last) + sum_t wts_t (x dt)_t B_t^T, entries
    // (ty * PPT + i, tx + 16 c), each owned by one thread
    {
      float inc[PPT][NPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int c = 0; c < NPT; ++c) inc[i][c] = 0.f;
      for (int t = 0; t < nq; ++t) {
        const float w = wts[t];
        float xw[PPT], bv[NPT];
#pragma unroll
        for (int i = 0; i < PPT; ++i) xw[i] = w * Xs[t * LDP + ty * PPT + i];
#pragma unroll
        for (int c = 0; c < NPT; ++c) bv[c] = Bs[t * LDN + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < PPT; ++i)
#pragma unroll
          for (int c = 0; c < NPT; ++c) inc[i][c] = fmaf(xw[i], bv[c], inc[i][c]);
      }
      const float cdec = expf(c_last);
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int c = 0; c < NPT; ++c) {
          float* sp = Ss + (ty * PPT + i) * LDN + tx + 16 * c;
          *sp = fmaf(*sp, cdec, inc[i][c]);
        }
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }

  for (int i = tid; i < P * N; i += NT) final_state[state_off + i] = Ss[(i / N) * LDN + i % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* init_state, void* y, void* final_state, void* s_in, int B, int L, int H,
           int G, int Q, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<P, N>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_scan_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(H, B);
  ssd_scan_kernel<T, P, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(final_state), static_cast<float*>(s_in), L, H, G, Q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* s0, void* y, void* fs, void* si, int B, int L, int H,
               int G, int Q, cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int P, int N, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* s0, void* y, void* fs, void* si, int B, int L, int H,
             int G, int Q, cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, s0, y, fs, si, B, L, H, G, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- bf16, tensor cores (wgmma)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int HG_MAX = 8;   // heads per ssd_chunk_out block, at most
constexpr int XSTAGES = 3;  // x tiles in ssd_chunk_out's ring
constexpr int PSTAGES = 2;  // chunks in ssd_state_pass's ring
static_assert(XSTAGES >= 2 && PSTAGES >= 2, "a ring holds the tile in use and the next");

// ------------------------------------------------------------ ssd_state_pass
template <int Q, int P, int N>
struct StateSlot {  // one chunk of ssd_state_pass's ring
  bf16 x[Q * P];    // core-matrix layout, rows t
  bf16 b[Q * N];    // core-matrix layout, rows t
  float dt[Q];
};

template <int Q, int P, int N>
constexpr size_t state_smem() {
  return PSTAGES * sizeof(StateSlot<Q, P, N>) + 4 * Q * sizeof(float);
}

template <int Q, int P, int N>
__global__ void __launch_bounds__(128)
ssd_state_pass(const bf16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const bf16* __restrict__ Bm,
               const float* __restrict__ init_state, float* __restrict__ s_in,
               float* __restrict__ final_state, int L, int H, int G) {
  using Slot = StateSlot<Q, P, N>;
  constexpr uint32_t GROUP_N = N / 8 * 128;  // bytes between 8-row groups of a B tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Slot* ring = reinterpret_cast<Slot*>(smem_raw);
  float* wts = reinterpret_cast<float*>(smem_raw + PSTAGES * sizeof(Slot));  // 4 x Q

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = warp_uniform(tid / 32), lane = tid % 32;
  const int nc = (L + Q - 1) / Q;
  const float a = A[h];
  // Accumulator rows p0 and p0 + 8 (d[4 i + e], e / 2 picks the row), column
  // 8 i + 2 (lane % 4) + e % 2. At P = 32 warps 2 and 3 hold zero rows.
  const int p0 = 16 * warp + lane / 4;
  const bool rows_ok = 16 * warp < P;  // uniform over the warp
  const int64_t st_off = ((int64_t)b * H + h) * P * N;
  const int grp = h / (H / G);  // the group of B this head reads

  auto issue = [&](int c) {  // copies of chunk c into its slot, as one commit group
    if (c < nc) {
      const int l0 = c * Q, nq = min(Q, L - l0);
      Slot& s = ring[c % PSTAGES];
      load_tile<P, Q, 128>(s.x, nq, [&](int r) {
        return x + (((int64_t)b * L + l0 + r) * H + h) * P;
      });
      load_tile<N, Q, 128>(s.b, nq, [&](int r) {
        return Bm + (((int64_t)b * L + l0 + r) * G + grp) * N;
      });
      for (int t = tid; t < Q; t += 128) {
        const bool ok = t < nq;
        cp_async_4(&s.dt[t], dt + ((int64_t)b * L + l0 + (ok ? t : 0)) * H + h, ok);
      }
    }
    cp_async_commit();
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 8 * (e / 2), n = 8 * i + 2 * (lane % 4) + e % 2;
      acc[4 * i + e] = init_state != nullptr && rows_ok ? init_state[st_off + p * N + n] : 0.f;
    }

#pragma unroll
  for (int c = 0; c < PSTAGES - 1; ++c) issue(c);
  float* w = wts + warp * Q;  // this warp's copy of the chunk's weights
  for (int c = 0; c < nc; ++c) {
    cp_async_wait<PSTAGES - 2>();  // this thread's copies of chunk c have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; every read of chunk c - 1's slot is done
    issue(c + PSTAGES - 1);
    const Slot& s = ring[c % PSTAGES];

    // weights w_t = dt_t exp(cums_last - cums_t) (0 past L, where dt = 0)
    const float last = ssd_tc::warp_cumsum_log2<Q>(s.dt, a, w, lane);
#pragma unroll
    for (int k = 0; k < Q / 32; ++k) {
      const int t = lane * (Q / 32) + k;
      w[t] = s.dt[t] * fast_exp2(last - w[t]);
    }
    __syncwarp();

    // the state at the chunk's start, then its decay over the chunk
    if (rows_ok) {
      float* so = s_in + (((int64_t)b * nc + c) * H + h) * P * N;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(so + (p0 + 8 * r) * N + 8 * i + 2 * (lane % 4)) =
              make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
    const float decay = fast_exp2(last);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] *= decay;

    // A = (x w)^T in bf16: ldmatrix.trans of the x tile (rows t, columns p),
    // each pair of t scaled by its weights
    uint32_t xa[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (rows_ok) {
        const int j = lane / 8;
        const int t = 16 * kk + 8 * (j / 2) + lane % 8, pc = 16 * warp + 8 * (j % 2);
        ldmatrix_x4_trans(xa[kk], s.x + ((t / 8) * (P / 8) + pc / 8) * 64 + (t % 8) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 wt =
              *reinterpret_cast<const float2*>(w + 16 * kk + 8 * (r / 2) + 2 * (lane % 4));
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xa[kk][r]));
          xa[kk][r] = pack_bf16x2(v.x * wt.x, v.y * wt.y);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) xa[kk][r] = 0u;
      }
    }

    // state += A . B_c (B_c MN-major: rows t, columns n)
    const uint64_t db = wgmma_desc(s.b, GROUP_N, 128);
    fence_regs(acc);
    fence_regs(xa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) wgmma_rs(acc, xa[kk], db + kk * 2 * GROUP_N / 16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
  }
  cp_async_wait<0>();

  if (rows_ok) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(final_state + st_off + (p0 + 8 * r) * N + 8 * i +
                                   2 * (lane % 4)) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ------------------------------------------------------------- ssd_chunk_out
template <int Q, int P, int N>
struct OutSmem {
  bf16 c[Q * N];           // C_c, core-matrix layout, rows i
  bf16 b[Q * N];           // B_c, rows j
  bf16 x[XSTAGES][Q * P];  // x of one head per slot, rows j
  bf16 s[2][P * N];        // S_in of one head per slot, bf16, rows p
  float c2[HG_MAX][Q];     // log2(e) cums per head
  float dt[HG_MAX][Q];     // dt per head (0 past L)
};

template <int Q, int P, int N>
__global__ void __launch_bounds__(2 * Q, 1)
ssd_chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ s_in,
              bf16* __restrict__ y, int L, int H, int ngroups, int hg) {
  constexpr int WGS = Q / 64, NT = 128 * WGS;
  constexpr uint32_t GROUP_N = N / 8 * 128;  // bytes between 8-row groups, C/B/S tiles
  constexpr uint32_t GROUP_P = P / 8 * 128;  // ... of an x tile
  constexpr int SCH = P * N / 8;             // 16-byte chunks of a bf16 S tile
  constexpr int SPT = (SCH + NT - 1) / NT;   // of them per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  OutSmem<Q, P, N>& sm = *reinterpret_cast<OutSmem<Q, P, N>*>(smem_raw);

  // the block's heads: HG of its group's rep, the group's last block partial
  const int rep = H / ngroups, bpg = (rep + hg - 1) / hg;  // heads and blocks per group
  const int grp = blockIdx.x / bpg, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * rep + (blockIdx.x % bpg) * hg;
  const int nc = gridDim.y;
  const int nh = warp_uniform(min(hg, (grp + 1) * rep - h0));  // heads of this block
  const int l0 = c * Q, nq = min(Q, L - l0);
  const int tid = threadIdx.x;
  const int wg = warp_uniform(tid / 128), warp = warp_uniform((tid % 128) / 32), lane = tid % 32;
  const int64_t row0 = (int64_t)b * L + l0;  // the chunk's first row of the sequence

  load_tile<N, Q, NT>(sm.c, nq, [&](int r) { return Cm + ((row0 + r) * ngroups + grp) * N; });
  load_tile<N, Q, NT>(sm.b, nq, [&](int r) { return Bm + ((row0 + r) * ngroups + grp) * N; });
  auto issue_x = [&](int g) {  // x of head g into its slot, as one commit group
    if (g < nh)
      load_tile<P, Q, NT>(sm.x[g % XSTAGES], nq, [&](int r) {
        return x + ((row0 + r) * H + h0 + g) * P;
      });
    cp_async_commit();
  };
#pragma unroll
  for (int g = 0; g < XSTAGES - 1; ++g) issue_x(g);  // C and B travel with x of head 0

  // S_in of head g: SPT 16-byte chunks of the bf16 tile per thread, read as f32
  float4 sv[SPT][2];
  auto load_s = [&](int g) {
    const float* src = s_in + (((int64_t)b * nc + c) * H + h0 + g) * P * N;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int i = tid + k * NT;
      if (i < SCH) {
        const int r = (i / (8 * (N / 8))) * 8 + i % 8, col = ((i / 8) % (N / 8)) * 8;
        sv[k][0] = *reinterpret_cast<const float4*>(src + r * N + col);
        sv[k][1] = *reinterpret_cast<const float4*>(src + r * N + col + 4);
      }
    }
  };
  auto store_s = [&](int slot) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int i = tid + k * NT;
      if (i < SCH)
        reinterpret_cast<uint4*>(sm.s[slot])[i] =
            make_uint4(pack_bf16x2(sv[k][0].x, sv[k][0].y), pack_bf16x2(sv[k][0].z, sv[k][0].w),
                       pack_bf16x2(sv[k][1].x, sv[k][1].y), pack_bf16x2(sv[k][1].z, sv[k][1].w));
    }
  };
  load_s(0);

  // dt of the group's heads (coalesced over heads), then one warp per head
  // takes its cumsum
  for (int i = tid; i < Q * HG_MAX; i += NT) {
    const int t = i / HG_MAX, g = i % HG_MAX;
    sm.dt[g][t] = t < nq && g < nh ? dt[(row0 + t) * H + h0 + g] : 0.f;
  }
  __syncthreads();
  for (int g = tid / 32; g < nh; g += NT / 32)
    ssd_tc::warp_cumsum_log2<Q>(sm.dt[g], A[h0 + g], sm.c2[g], lane);
  store_s(0);
  cp_async_wait<XSTAGES - 2>();  // C, B and x of head 0 have landed
  fence_proxy_async();
  __syncthreads();

  // G = C . B^T for this warpgroup's rows, 64 columns at a time, only the
  // column blocks its rows can see
  const uint64_t dc = wgmma_desc(sm.c + wg * 64 * N, 128, GROUP_N);
  const uint64_t dbm = wgmma_desc(sm.b, 128, GROUP_N);
  float G[WGS][32] = {};  // a block its rows cannot see stays 0 and unread
  fence_regs(G);
  wgmma_fence();
#pragma unroll
  for (int cb = 0; cb < WGS; ++cb) {
    if (cb <= wg) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_ss(G[cb], dc + 16 * kk, dbm + cb * (8 * GROUP_N / 16) + 16 * kk, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(G);

  const int r0 = 64 * wg + 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
  const int nkk = 4 * (wg + 1);                   // k steps of P . x its rows can see
  float acc[P / 2] = {};
  uint32_t pa[Q / 16][4] = {};  // k steps past nkk stay 0 and unread
  for (int g = 0; g < nh; ++g) {
    if (g > 0) {
      cp_async_wait<XSTAGES - 2>();  // this thread's copies of x of head g have landed
      fence_proxy_async();           // ... and its writes of S_in of head g
      __syncthreads();  // everyone's; every read of head g - 1's slots is done
    }
    issue_x(g + XSTAGES - 1);
    if (g + 1 < nh) load_s(g + 1);  // in flight while head g computes
    const float* c2 = sm.c2[g];
    const float* dtg = sm.dt[g];

    // acc = C . S_in^T (S_in K-major: rows p, columns n)
    const uint64_t ds = wgmma_desc(sm.s[g % 2], 128, GROUP_N);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_ss(acc, dc + 16 * kk, ds + 16 * kk, kk > 0);
    wgmma_commit();

    // meanwhile P = G exp(cums_i - cums_j) dt_j for j <= i, else 0, in bf16
    // as the A operand of P . x. Of the column block on the diagonal
    // (cb = wg), this warp's 16 rows see all of the 8-column groups
    // ii < 2 warp, part of 2 warp and 2 warp + 1 (masked by a select) and
    // none past them (zero, no exp).
    const float ci[2] = {c2[r0], c2[r0 + 8]};
#pragma unroll
    for (int cb = 0; cb < WGS; ++cb) {
      if (cb <= wg) {
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int col = 64 * cb + 8 * ii + 2 * (lane % 4);
          const int part = cb < wg ? -1 : ii - 2 * warp;  // < 0: all seen, 0 or 1: masked
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (part <= 1) {  // uniform over the warp
            const float2 cj = *reinterpret_cast<const float2*>(c2 + col);
            const float2 dj = *reinterpret_cast<const float2*>(dtg + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float cjv = e % 2 ? cj.y : cj.x, djv = e % 2 ? dj.y : dj.x;
              v[e] = G[cb][4 * ii + e] * fast_exp2(ci[e / 2] - cjv) * djv;
              if (part >= 0 && col + e % 2 > r0 + 8 * (e / 2)) v[e] = 0.f;
            }
          }
          pa[4 * cb + ii / 2][2 * (ii % 2)] = pack_bf16x2(v[0], v[1]);
          pa[4 * cb + ii / 2][2 * (ii % 2) + 1] = pack_bf16x2(v[2], v[3]);
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    const float ei[2] = {fast_exp2(ci[0]), fast_exp2(ci[1])};
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      acc[4 * i + 0] *= ei[0];
      acc[4 * i + 1] *= ei[0];
      acc[4 * i + 2] *= ei[1];
      acc[4 * i + 3] *= ei[1];
    }

    // acc += P . x (x MN-major: rows j, columns p)
    const uint64_t dx = wgmma_desc(sm.x[g % XSTAGES], GROUP_P, 128);
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
      if (kk < nkk) wgmma_rs(acc, pa[kk], dx + kk * 2 * GROUP_P / 16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < nq) {
        bf16* dst = y + ((row0 + row) * H + h0 + g) * P + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < P / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
      }
    }
    if (g + 1 < nh) store_s((g + 1) % 2);  // its last reader, head g - 1, is done
  }
  cp_async_wait<0>();  // no copy outlives the block (the ring's last groups are empty)
}

template <int Q, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* init_state, void* y, void* final_state, void* s_in, int B, int L, int H,
           int G, cudaStream_t stream) {
  constexpr size_t smem_state = state_smem<Q, P, N>();
  constexpr size_t smem_out = sizeof(OutSmem<Q, P, N>);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_state_pass<Q, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_state);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_out<Q, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_out);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
  }
  const int nc = (L + Q - 1) / Q, rep = H / G;
  int hg = HG_MAX;  // halved while the grid would leave SMs without a block, then at most rep
  while (hg > 1 && (int64_t)G * ((rep + hg - 1) / hg) * nc * B < sms) hg /= 2;
  hg = min(hg, rep);
  ssd_state_pass<Q, P, N><<<dim3(H, B), 128, smem_state, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const float*>(init_state),
      static_cast<float*>(s_in), static_cast<float*>(final_state), L, H, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_out<Q, P, N><<<dim3(G * ((rep + hg - 1) / hg), nc, B), 2 * Q, smem_out, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const float*>(s_in), static_cast<bf16*>(y), L, H, G, hg);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, V>{}) for V in the route's values.
template <class F>
int with_n(int N, F&& f) {
  switch (N) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int P, int N, int Q, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* s0, void* y, void* fs, void* s_in, int B, int L, int H,
             int G, cudaStream_t st) {
  auto go = [&](auto q, auto p) {
    return with_n(N, [&](auto n) {
      return launch<decltype(q)::value, decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, s0, y, fs, s_in, B, L, H, G, st);
    });
  };
  using I64 = std::integral_constant<int, 64>;
  using I32 = std::integral_constant<int, 32>;
  using I128 = std::integral_constant<int, 128>;
  if (Q == 64 && P == 32) return go(I64{}, I32{});
  if (Q == 64 && P == 64) return go(I64{}, I64{});
  if (Q == 128 && P == 32) return go(I128{}, I32{});
  if (Q == 128 && P == 64) return go(I128{}, I64{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x (B, L, H, P), dt (B, L, H) f32, A (H,) f32, Bm/Cm (B, L, G, N) with H a
// multiple of G (head h reads group h / (H / G)), init_state
// (B, H, P, N) f32 or null (zeros), y (B, L, H, P), final_state (B, H, P, N)
// f32; all contiguous, on the stream's device; chunks of 1 <= Q <= 128 rows.
// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16. s_in: f32 (B,
// ceil(L / Q), H, P, N), the state at every chunk start. route 1 is the
// tensor-core route, which takes bf16 with Q in {64, 128}, P in {32, 64}, N
// in {32, 64, 128} (ssd_scan/ops.py::route), needs s_in as its scratch and
// launches ssd_state_pass, then ssd_chunk_out; route 0 the scalar kernel,
// which writes s_in where it is given (the backward, ssd_scan_bwd.cu, reads
// it) and skips it where it is null. Returns the first failed launch's
// cudaError_t, else 0.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* init_state, void* y,
                              void* final_state, void* s_in, int B, int L, int H, int G, int P,
                              int N, int Q, int dtype, int route, void* stream) {
  if (Q < 1 || Q > QMAX || L < 1 || G < 1 || H % G) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || s_in == nullptr) return (int)cudaErrorInvalidValue;
    return tc::dispatch(P, N, Q, x, dt, A, Bm, Cm, init_state, y, final_state, s_in, B, L, H, G,
                        s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(P, N, x, dt, A, Bm, Cm, init_state, y, final_state, s_in, B, L, H, G,
                           Q, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, init_state, y, final_state, s_in, B,
                                   L, H, G, Q, s);
  return (int)cudaErrorInvalidValue;
}
