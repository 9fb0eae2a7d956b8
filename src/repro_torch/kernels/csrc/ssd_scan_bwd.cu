// Backward of the Mamba2 SSD chunked scan (ssd_scan.cu, G groups of B and
// C), for Hopper.
//
// Replaces what the reference gets from XLA's autodiff of its plain scan
// (src/repro/models/ssm.py::ssd_chunked): the TPU kernel src/repro/kernels/
// ssd_scan/kernel.py has no gradient, and the reference trains on the plain
// scan. Per (batch b, head h) and chunk of Q rows, with a = dt A, cums its
// inclusive cumsum in the chunk, last its last row, G = C B^T of the head's
// group (head h reads group h / (H / ngroups) of B and C, rows of ngroups N
// elements, as in the forward), E_ij = exp(cums_i - cums_j) for j <= i (else
// 0), M = G E, S the state at the chunk's start (S_in, saved by the forward)
// and dS the gradient of the state at its end:
//   dS_start = exp(cums_last) dS + sum_i exp(cums_i) dy_i C_i^T
//   dx_j = dt_j (sum_i M_ij dy_i + exp(cums_last - cums_j) dS B_j)
//   dC_i = sum_j dG_ij B_j + exp(cums_i) S^T dy_i,  dG_ij = (dy_i . x_j) dt_j E_ij
//   dB_j = sum_i dG_ij C_i + exp(cums_last - cums_j) dt_j dS^T x_j
//   ddt_j = sum_i M_ij (dy_i . x_j) + exp(cums_last - cums_j) u_j + A da_j,
//     u_j = x_j . dS B_j,
// dB and dC of a group summed over its heads, da the reverse cumsum in the
// chunk of
//   dcums_i = sum_j R_ij - sum_k R_ki + exp(cums_i) C_i . S^T dy_i
//             - exp(cums_last - cums_i) dt_i u_i,  R_ij = M_ij dt_j (dy_i . x_j),
// plus exp(cums_last) <dS, S> + sum_j exp(cums_last - cums_j) dt_j u_j on
// the chunk's last row, and dA = sum dt da. The plain version is
// ssd_scan/ref.py::ssd_chunked_bwd. As in the forward, E is evaluated only
// where j <= i (a select, never a multiplied mask: above the diagonal the
// exp overflows and inf * 0 is NaN), and never factored as exp(cums_i)
// exp(-cums_j), which overflows late in a chunk.
//
// What bounds it on the card: per (b, h, chunk) the function needs about
// 2 Q^2 (2 P + 3 N) + 8 Q P N operations (G, dy.x^T, M^T dy, dG B, dG^T C
// and the four state products) against x, dy and dx (Q x P each) and S_in
// (P x N, f32) read or written once, and dt, B, C and their gradients once
// (B, C, dB and dC once per group). At zamba2-2.7b's training microbatch
// (B = 4, L = 2048, H = 80, P = N = 64, Q = 128, bf16, one group) that is
// ~7.5e10 operations against ~0.35 GB: bound by bytes (0.10 ms at 3.35
// TB/s), as the forward; 8 groups add 29.4 MB of B, C, dB and dC.
//
// Two routes, chosen before any launch by dtype and shape
// (ssd_scan/ops.py::route at the backward's chunk min(chunk, L), a fixed
// choice and never a fallback), each three kernels in one C call,
// deterministic: no atomics, and every sum runs in a fixed order, so two
// calls on the same inputs give the same bits.
//
// bf16 at Q in {64, 128}, P in {32, 64}, N in {32, 64, 128}: tensor cores,
// as the forward's route (ssd_scan.cu), every product on wgmma with f32
// accumulators. Its rounding points are ref.py::
// ssd_tensor_core_bwd_emulation: bf16 operands exp(cums) dy (state pass), M
// and dG, dS and S (the state products); G, dy.x^T, K, R and every sum that
// feeds ddt, dcums and dA stay f32.
//   ssd_state_bwd_wgmma, grid (H, B), one warpgroup per (b, h):
//   ssd_state_pass run backwards. dS (rows p, 64 per product: at P = 32 the
//   upper rows are zero) lives in f32 accumulators; per chunk, last to
//   first, it stores dS to ds_end, scales it by exp(cums_last) and
//   accumulates (dy exp(cums))^T . C (M = P, N = N, K = Q), the scaled dy
//   read transposed by ldmatrix.trans and rounded once as the register A
//   operand, C MN-major. dy, C and dt of the next chunk arrive by cp.async
//   (a ring of two). Where the chunk kernel splits its passes (N = 128) it
//   also takes <dS, S> per chunk in f32, parked in the dA partials' scratch.
//   ssd_chunk_bwd_wgmma, grid (ngroups ceil(rep / HG), NC, B) with rep =
//   H / ngroups heads per group, Q / 64 warpgroups of 64 rows, HG heads of
//   one group per block in turn (the group's last block partial), two
//   passes per head:
//     pass 1, transposed (this warpgroup's rows j): v = B dS^T and z = x dS;
//     then, per 64-column block of i its rows see (i >= j; the causal
//     triangle's hidden blocks are skipped), G^T = B C^T and x dy^T, and
//     M^T = G^T E^T and dG^T = (x dy^T) E^T dt_j rounded to bf16 in
//     registers as the A operands of dx += M^T dy and dB += dG^T C (dy and C
//     MN-major): the column-indexed outputs land in registers. u and the
//     column sums of K come from the f32 registers (a quad's shuffles).
//     pass 2, as the forward (rows i): w = dy S, qv_i = C_i . w_i and
//     dC += exp(cums_i) w; per block of j its rows see, G and dy x^T again,
//     dG rounded as the A operand of dC += dG B, and the row sums of R. The
//     recomputation (one more 64 x 64 x (N + P) product pair per block, a
//     third more tensor-core work than one pass) keeps no Q x Q matrix in
//     shared memory and no barrier between the warpgroups inside a head.
//   At N <= 64 one step per head runs both passes, dB and dC accumulating in
//   registers side by side over the block's heads, and a warpgroup does 3
//   column blocks per head at Q = 128 whichever its rows. At N = 128 the two
//   accumulators (64 registers each) do not fit beside the passes' working
//   set: every head's pass 1 runs, then every head's pass 2, x and dy read
//   twice. x and dy of the next step and its dS and S (f32) arrive by
//   cp.async while the current step computes; at the step's start the f32
//   state tiles are rounded into bf16 operand tiles (fused, <dS, S> comes
//   from them in f32). Then one warp per head: dcums, its reverse cumsum da,
//   ddt and the head's dA term. dB and dC leave as one f32 partial per block
//   (each entry one thread's, no read-modify-write), summed over the head
//   groups in order by ssd_bwd_reduce.
//   Registers: 180-253 a thread without spills, so one block of 8 warps per
//   SM; shared memory up to 216 KB (Q = 128, P = 64, N = 128). What holds
//   the route back (PERF.md): each head's chain of dependent steps (seven
//   wgmma waits and the element-wise work between them, the exp of every
//   visible E twice) with no other block on the SM to hide it, and the state
//   pass's chain over the chunks. Left on the table: TMA tile loads behind
//   mbarriers with a producer warp (every copy is a thread's cp.async),
//   ds_end in bf16 (rounded before each product anyway; <dS, S> would then
//   need the f32 dS where the state pass has it), G held across heads where
//   registers allow, and pipelining one block's products behind the last's
//   (tried: G and D of the next block held across the wait spilled).
//   A block's heads lie in one group, so its B and C tiles (and G) serve
//   every head of the block, and its dB, dC partials belong to that group.
//
// Everything else, all of f32 included (held to 1e-4, which bf16 tensor
// cores cannot meet): the first version's scalar kernels, f32 FMAs from f32
// shared tiles (bf16 inputs are widened as they land, so the scalar route
// rounds nothing but its outputs dx, dB and dC). 256 threads as a 16 x 16
// grid (ty, tx); tiles have odd row strides.
// (a) ssd_state_bwd, grid (H, B): the only sequential part. One block per
//     (b, h) walks the chunks last to first, carrying dS (P x N, f32) in
//     registers (entries (ty P/16 + i, tx + 16 c), as the forward's state):
//     at each chunk it writes dS (the gradient at the chunk's end) to the f32
//     scratch dS_end (B, NC, H, P, N), then folds the chunk in. dinit is the
//     last dS.
// (b) ssd_chunk_bwd, grid (ngroups ceil(rep / HG), NC, B): every chunk at
//     once, HG heads of one group per block in turn. Per head two passes over the lower triangle
//     of the Q x Q matrices in tiles of TB = 32, so that no Q x Q matrix is
//     ever whole in shared memory:
//       pass 1, by column tiles J (C and dy whole, B_J and x_J, dS): G and
//       dy.x^T of the tile, then M, dG and K = M (dy.x^T) into two tiles;
//       dx_J, dB_J, u_J and the column sums of K are complete per tile; the
//       row sums of K dt accumulate;
//       pass 2, by row tiles I (B and x whole, C_I and dy_I, S): dy.x^T again
//       (G is not needed), dG into one tile; dC_I and C_I . S^T dy_I.
//     Then dcums, its reverse cumsum da (one warp), ddt and this head's dA
//     term. dx and ddt are written directly; dB and dC go to f32 partials
//     per block (B, NC, ngroups ceil(rep / HG), Q, N), each entry owned by one
//     thread for every head of the block (read, add, write: no barrier, no
//     atomic); dA to a partial per (b, chunk, head). Shared memory: C or B
//     and dy or x whole, dS or S, two tiles: 140 KB at P = N = 64, 198 KB at
//     P = 64, N = 128 (mamba2-130m), one block per SM.
// (c) ssd_bwd_reduce: dB and dC of each group summed over its blocks in
//     order and rounded to x's dtype; dA summed over (b, chunk) in order by the last
//     block.
//
// Both routes: rows past L are zero-filled and dt there is 0, so they reach
// no gradient, and no gradient is written for them.

#include "common.cuh"
#include "sm90.cuh"
#include "ssd_tc.cuh"

namespace {

constexpr int QMAX = 128;  // most rows in one chunk
constexpr int NT = 256;    // threads per block, a 16 x 16 grid
constexpr int TB = 32;     // rows or columns of a tile of the Q x Q matrices
constexpr int LDT = TB + 1;    // row stride of a pass-1 tile (QMAX rows)
constexpr int LDU = QMAX + 1;  // row stride of the pass-2 tile (TB rows)
constexpr int TILE = QMAX * LDT;  // floats of one tile region, >= TB * LDU
constexpr int RG = 4;      // row (pass 1) or column (pass 2) steps of 16 per register tile
static_assert(TILE >= TB * LDU, "the pass-2 tile fits a pass-1 tile region");

// Sum over the 16 lanes of a half warp (xor butterfly: every lane gets the
// same bits, in a fixed order). Every lane of the warp must call it.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the 32 lanes of a warp, the same way.
__device__ __forceinline__ float sum32(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return sum16(v);
}

// Inclusive cumsum of a * dts[0 .. QMAX) by one warp (dts is 0 past the
// chunk's rows, so cum there stays at the last row's value), as the forward's
// scalar kernel computes it.
__device__ __forceinline__ void warp_cumsum(const float* dts, float a, float* cum, int lane) {
  constexpr int PER = QMAX / 32;
  float part[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += dts[lane * PER + k] * a;
    part[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) cum[lane * PER + k] = incl - run + part[k];
}

// In place, by one warp: v[t] <- sum_{i >= t} v[i] over [0, Q).
template <int Q>
__device__ __forceinline__ void warp_reverse_cumsum(float* v, int lane) {
  constexpr int PER = Q / 32;
  float part[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += v[Q - 1 - (lane * PER + k)];
    part[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < PER; ++k) v[Q - 1 - (lane * PER + k)] = incl - run + part[k];
}

// ------------------------------------------------------------- ssd_state_bwd
template <int P, int N>
constexpr size_t state_smem() {
  return sizeof(float) * (QMAX * (N + 1) + QMAX * (P + 1) + 3 * QMAX);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_state_bwd(const T* __restrict__ dy, const float* __restrict__ dt, const float* __restrict__ A,
              const T* __restrict__ Cm, const float* __restrict__ dfinal,
              float* __restrict__ ds_end, float* __restrict__ dinit, int L, int H, int G, int Q) {
  constexpr int LDN = N + 1, LDP = P + 1, PPT = P / 16, NPT = N / 16;
  extern __shared__ float smem[];
  float* Cs = smem;              // QMAX x LDN
  float* Ys = Cs + QMAX * LDN;   // QMAX x LDP: dy
  float* cum = Ys + QMAX * LDP;  // QMAX
  float* dts = cum + QMAX;       // QMAX
  float* ei = dts + QMAX;        // QMAX: exp(cums) (0 past the chunk)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nc = (L + Q - 1) / Q;
  const float a = A[h];
  const int64_t st_off = ((int64_t)b * H + h) * P * N;
  const int grp = h / (H / G);  // the group of C this head reads

  float ds[PPT][NPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i)
#pragma unroll
    for (int c = 0; c < NPT; ++c)
      ds[i][c] = dfinal != nullptr ? dfinal[st_off + (ty * PPT + i) * N + tx + 16 * c] : 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const int l0 = c * Q, nq = min(Q, L - l0);
    float* out = ds_end + (((int64_t)b * nc + c) * H + h) * P * N;
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int k = 0; k < NPT; ++k) out[(ty * PPT + i) * N + tx + 16 * k] = ds[i][k];
    {
      RowTile<T, P, QMAX, NT> yt;
      yt.load(dy + (((int64_t)b * L + l0) * H + h) * P, (int64_t)H * P, nq);
      yt.store(Ys, LDP);
    }
    {
      RowTile<T, N, QMAX, NT> ct;
      ct.load(Cm + (((int64_t)b * L + l0) * G + grp) * N, (int64_t)G * N, nq);
      ct.store(Cs, LDN);
    }
    if (tid < QMAX) dts[tid] = tid < nq ? dt[((int64_t)b * L + l0 + tid) * H + h] : 0.f;
    __syncthreads();
    if (tid < 32) warp_cumsum(dts, a, cum, tid);
    __syncthreads();
    if (tid < QMAX) ei[tid] = tid < nq ? expf(cum[tid]) : 0.f;
    __syncthreads();

    // dS <- exp(cums_last) dS + sum_t exp(cums_t) dy_t C_t^T
    const float dec = expf(cum[nq - 1]);
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int k = 0; k < NPT; ++k) ds[i][k] *= dec;
    for (int t = 0; t < nq; ++t) {
      const float e = ei[t];
      float yv[PPT], cv[NPT];
#pragma unroll
      for (int i = 0; i < PPT; ++i) yv[i] = e * Ys[t * LDP + ty * PPT + i];
#pragma unroll
      for (int k = 0; k < NPT; ++k) cv[k] = Cs[t * LDN + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < PPT; ++i)
#pragma unroll
        for (int k = 0; k < NPT; ++k) ds[i][k] = fmaf(yv[i], cv[k], ds[i][k]);
    }
    __syncthreads();  // the next chunk overwrites the tiles
  }
  if (dinit != nullptr) {
#pragma unroll
    for (int i = 0; i < PPT; ++i)
#pragma unroll
      for (int k = 0; k < NPT; ++k) dinit[st_off + (ty * PPT + i) * N + tx + 16 * k] = ds[i][k];
  }
}

// ------------------------------------------------------------- ssd_chunk_bwd
template <int P, int N>
constexpr size_t chunk_smem() {
  return sizeof(float) * (QMAX * (N + 1) + QMAX * (P + 1) + P * (N + 1) + TB * (N + 1) +
                          TB * (P + 1) + 2 * TILE + 16 * TB + 9 * QMAX + NT / 32);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT, 1)
ssd_chunk_bwd(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
              const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
              const float* __restrict__ s_in, const float* __restrict__ ds_end,
              T* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
              float* __restrict__ dcp, float* __restrict__ dap, int L, int H, int G, int Q,
              int hg) {
  constexpr int LDN = N + 1, LDP = P + 1, PPT = P / 16, NPT = N / 16;
  extern __shared__ float smem[];
  float* F1 = smem;               // QMAX x LDN: C (pass 1), B (pass 2)
  float* F2 = F1 + QMAX * LDN;    // QMAX x LDP: dy (pass 1), x (pass 2)
  float* ST = F2 + QMAX * LDP;    // P x LDN: dS (pass 1), S (pass 2)
  float* SB = ST + P * LDN;       // TB x LDN: B_J (pass 1), C_I (pass 2)
  float* SX = SB + TB * LDN;      // TB x LDP: x_J (pass 1), dy_I (pass 2)
  float* T1 = SX + TB * LDP;      // M (pass 1, QMAX x LDT); dG (pass 2, TB x LDU)
  float* T2 = T1 + TILE;          // dG (pass 1, QMAX x LDT)
  float* red = T2 + TILE;         // 16 x TB: column sums of K by ty
  float* cum = red + 16 * TB;     // the vectors, QMAX each
  float* dts = cum + QMAX;
  float* ei = dts + QMAX;         // exp(cums_i)
  float* eo = ei + QMAX;          // exp(cums_last - cums_j)
  float* rowr = eo + QMAX;        // sum_j R_ij
  float* colk = rowr + QMAX;      // sum_i K_ij
  float* uu = colk + QMAX;        // u_j = x_j . dS B_j
  float* qv = uu + QMAX;          // C_i . S^T dy_i
  float* dcum = qv + QMAX;        // dcums, then da
  float* wsum = dcum + QMAX;      // 8 warps' partial sums

  // the block's heads: HG of its group's rep, the group's last block partial
  const int rep = H / G, bpg = (rep + hg - 1) / hg;  // heads and blocks per group
  const int grp = blockIdx.x / bpg, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * rep + (blockIdx.x % bpg) * hg;
  const int nc = gridDim.y;
  const int nh = min(hg, (grp + 1) * rep - h0);
  const int l0 = c * Q, nq = min(Q, L - l0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, lane = tid % 32, warp = tid / 32;
  const int64_t row0 = (int64_t)b * L + l0;  // the chunk's first row of the sequence
  const int64_t gs = (int64_t)G * N;  // elements between rows of B or C
  const T* Bg = Bm + grp * N;         // row r of the group's B at Bg + r * gs
  const T* Cg = Cm + grp * N;
  const int64_t part = (((int64_t)b * nc + c) * gridDim.x + blockIdx.x) * Q * N;

  for (int g = 0; g < nh; ++g) {
    const int h = h0 + g;
    const float a = A[h];
    const int64_t st = (((int64_t)b * nc + c) * H + h) * P * N;

    if (tid < QMAX) dts[tid] = tid < nq ? dt[(row0 + tid) * H + h] : 0.f;
    {
      RowTile<T, N, QMAX, NT> ct;
      ct.load(Cg + row0 * gs, gs, nq);
      ct.store(F1, LDN);
    }
    {
      RowTile<T, P, QMAX, NT> yt;
      yt.load(dy + (row0 * H + h) * P, (int64_t)H * P, nq);
      yt.store(F2, LDP);
    }
    {
      RowTile<float, N, P, NT> dst;
      dst.load(ds_end + st, N, P);
      dst.store(ST, LDN);
    }
    __syncthreads();
    if (tid < 32) warp_cumsum(dts, a, cum, tid);
    __syncthreads();
    const float clast = cum[nq - 1];
    if (tid < QMAX) {
      const bool ok = tid < nq;
      ei[tid] = ok ? expf(cum[tid]) : 0.f;
      eo[tid] = ok ? expf(clast - cum[tid]) : 0.f;
      rowr[tid] = 0.f;
    }
    __syncthreads();

    // ---- pass 1: column tiles J = [j0, j0 + TB)
    for (int j0 = 0; j0 < nq; j0 += TB) {
      const int nj = min(TB, nq - j0);
      {
        RowTile<T, N, TB, NT> bt;
        bt.load(Bg + (row0 + j0) * gs, gs, nj);
        bt.store(SB, LDN);
      }
      {
        RowTile<T, P, TB, NT> xt;
        xt.load(x + ((row0 + j0) * H + h) * P, (int64_t)H * P, nj);
        xt.store(SX, LDP);
      }
      __syncthreads();

      // G and dy.x^T of rows i = j0 + ty + 16 r, columns j0 + tx and j0 + tx + 16;
      // M, dG into the tiles, the sums of K = M (dy.x^T)
      const int nr = (nq - j0 + 15) / 16;
      float colp[2] = {0.f, 0.f};
      for (int r0 = 0; r0 < nr; r0 += RG) {
        float gg[RG][2], dd[RG][2];
#pragma unroll
        for (int r = 0; r < RG; ++r) gg[r][0] = gg[r][1] = dd[r][0] = dd[r][1] = 0.f;
        int ir[RG];  // rows past the chunk are computed from a clamped row and dropped
#pragma unroll
        for (int r = 0; r < RG; ++r) ir[r] = min(j0 + ty + 16 * (r0 + r), QMAX - 1);
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float b0 = SB[tx * LDN + k], b1 = SB[(tx + 16) * LDN + k];
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float cv = F1[ir[r] * LDN + k];
            gg[r][0] = fmaf(cv, b0, gg[r][0]);
            gg[r][1] = fmaf(cv, b1, gg[r][1]);
          }
        }
#pragma unroll 4
        for (int k = 0; k < P; ++k) {
          const float x0 = SX[tx * LDP + k], x1 = SX[(tx + 16) * LDP + k];
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const float yv = F2[ir[r] * LDP + k];
            dd[r][0] = fmaf(yv, x0, dd[r][0]);
            dd[r][1] = fmaf(yv, x1, dd[r][1]);
          }
        }
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int i = j0 + ty + 16 * (r0 + r);
          float rs = 0.f;
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int jj = tx + 16 * cc, j = j0 + jj;
            float e = 0.f;
            if (i < nq && j <= i) e = expf(cum[i] - cum[j]);  // a select: never exp above
            const float m = gg[r][cc] * e, kk = m * dd[r][cc];
            if (i < nq) {
              T1[i * LDT + jj] = m;
              T2[i * LDT + jj] = dd[r][cc] * dts[j] * e;
            }
            colp[cc] += kk;
            rs = fmaf(kk, dts[j], rs);
          }
          rs = sum16(rs);
          if (tx == 0 && i < nq) rowr[i] += rs;
        }
      }
      red[ty * TB + tx] = colp[0];
      red[ty * TB + tx + 16] = colp[1];
      __syncthreads();
      if (tid < nj) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < 16; ++k) s += red[k * TB + tid];
        colk[j0 + tid] = s;
      }

      // dx_J and u_J: columns j0 + 2 ty + cc, x's columns tx + 16 e
      {
        float acc[2][PPT], v[2][PPT];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int e = 0; e < PPT; ++e) acc[cc][e] = v[cc][e] = 0.f;
        for (int i = j0; i < nq; ++i) {
          const float m0 = T1[i * LDT + 2 * ty], m1 = T1[i * LDT + 2 * ty + 1];
#pragma unroll
          for (int e = 0; e < PPT; ++e) {
            const float yv = F2[i * LDP + tx + 16 * e];
            acc[0][e] = fmaf(m0, yv, acc[0][e]);
            acc[1][e] = fmaf(m1, yv, acc[1][e]);
          }
        }
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          const float b0 = SB[(2 * ty) * LDN + k], b1 = SB[(2 * ty + 1) * LDN + k];
#pragma unroll
          for (int e = 0; e < PPT; ++e) {
            const float s = ST[(tx + 16 * e) * LDN + k];
            v[0][e] = fmaf(s, b0, v[0][e]);
            v[1][e] = fmaf(s, b1, v[1][e]);
          }
        }
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int jj = 2 * ty + cc, j = j0 + jj;
          float up = 0.f;
#pragma unroll
          for (int e = 0; e < PPT; ++e) up = fmaf(SX[jj * LDP + tx + 16 * e], v[cc][e], up);
          up = sum16(up);
          if (j < nq) {
            if (tx == 0) uu[j] = up;
            T* o = dx + ((row0 + j) * H + h) * P;
#pragma unroll
            for (int e = 0; e < PPT; ++e)
              o[tx + 16 * e] = from_f32<T>(dts[j] * fmaf(eo[j], v[cc][e], acc[cc][e]));
          }
        }
      }
      // dB_J: columns j0 + 2 ty + cc, B's columns tx + 16 k
      {
        float acc[2][NPT], z[2][NPT];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
#pragma unroll
          for (int k = 0; k < NPT; ++k) acc[cc][k] = z[cc][k] = 0.f;
        for (int i = j0; i < nq; ++i) {
          const float g0 = T2[i * LDT + 2 * ty], g1 = T2[i * LDT + 2 * ty + 1];
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            const float cv = F1[i * LDN + tx + 16 * k];
            acc[0][k] = fmaf(g0, cv, acc[0][k]);
            acc[1][k] = fmaf(g1, cv, acc[1][k]);
          }
        }
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          const float x0 = SX[(2 * ty) * LDP + p], x1 = SX[(2 * ty + 1) * LDP + p];
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            const float s = ST[p * LDN + tx + 16 * k];
            z[0][k] = fmaf(x0, s, z[0][k]);
            z[1][k] = fmaf(x1, s, z[1][k]);
          }
        }
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = j0 + 2 * ty + cc;
          if (j < nq) {
            const float w = eo[j] * dts[j];
            float* o = dbp + part + (int64_t)j * N;
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
              const float val = fmaf(w, z[cc][k], acc[cc][k]);
              o[tx + 16 * k] = g == 0 ? val : o[tx + 16 * k] + val;  // this thread's own entry
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites SB, SX, T1, T2 and red
    }

    // ---- pass 2: row tiles I = [i0, i0 + TB); B, x and S whole
    {
      RowTile<T, N, QMAX, NT> bt;
      bt.load(Bg + row0 * gs, gs, nq);
      bt.store(F1, LDN);
    }
    {
      RowTile<T, P, QMAX, NT> xt;
      xt.load(x + (row0 * H + h) * P, (int64_t)H * P, nq);
      xt.store(F2, LDP);
    }
    {
      RowTile<float, N, P, NT> st_tile;
      st_tile.load(s_in + st, N, P);
      st_tile.store(ST, LDN);
    }
    __syncthreads();
    {  // <dS, S>, in a fixed order
      float s = 0.f;
      for (int i = tid; i < P * N; i += NT) s = fmaf(ds_end[st + i], ST[(i / N) * LDN + i % N], s);
      s = sum32(s);
      if (lane == 0) wsum[warp] = s;
    }
    for (int i0 = 0; i0 < nq; i0 += TB) {
      const int ni = min(TB, nq - i0), jend = min(i0 + TB, nq);
      {
        RowTile<T, N, TB, NT> ctile;
        ctile.load(Cg + (row0 + i0) * gs, gs, ni);
        ctile.store(SB, LDN);
      }
      {
        RowTile<T, P, TB, NT> ytile;
        ytile.load(dy + ((row0 + i0) * H + h) * P, (int64_t)H * P, ni);
        ytile.store(SX, LDP);
      }
      __syncthreads();

      // dG of rows i0 + 2 ty + r, columns tx + 16 s (< jend)
      const int ns = (jend + 15) / 16;
      for (int s0 = 0; s0 < ns; s0 += RG) {
        float dd[2][RG];
#pragma unroll
        for (int s = 0; s < RG; ++s) dd[0][s] = dd[1][s] = 0.f;
        int jc[RG];
#pragma unroll
        for (int s = 0; s < RG; ++s) jc[s] = min(tx + 16 * (s0 + s), QMAX - 1);
#pragma unroll 4
        for (int k = 0; k < P; ++k) {
          const float y0 = SX[(2 * ty) * LDP + k], y1 = SX[(2 * ty + 1) * LDP + k];
#pragma unroll
          for (int s = 0; s < RG; ++s) {
            const float xv = F2[jc[s] * LDP + k];
            dd[0][s] = fmaf(y0, xv, dd[0][s]);
            dd[1][s] = fmaf(y1, xv, dd[1][s]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 2 * ty + r;
#pragma unroll
          for (int s = 0; s < RG; ++s) {
            const int j = tx + 16 * (s0 + s);
            if (j < jend) {
              float e = 0.f;
              if (i < nq && j <= i) e = expf(cum[i] - cum[j]);
              T1[(2 * ty + r) * LDU + j] = dd[r][s] * dts[j] * e;
            }
          }
        }
      }
      __syncthreads();

      // dC_I and C_I . S^T dy_I: rows i0 + 2 ty + r, C's columns tx + 16 k
      {
        float acc[2][NPT], w[2][NPT];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int k = 0; k < NPT; ++k) acc[r][k] = w[r][k] = 0.f;
        for (int j = 0; j < jend; ++j) {
          const float g0 = T1[(2 * ty) * LDU + j], g1 = T1[(2 * ty + 1) * LDU + j];
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            const float bv = F1[j * LDN + tx + 16 * k];
            acc[0][k] = fmaf(g0, bv, acc[0][k]);
            acc[1][k] = fmaf(g1, bv, acc[1][k]);
          }
        }
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          const float y0 = SX[(2 * ty) * LDP + p], y1 = SX[(2 * ty + 1) * LDP + p];
#pragma unroll
          for (int k = 0; k < NPT; ++k) {
            const float s = ST[p * LDN + tx + 16 * k];
            w[0][k] = fmaf(y0, s, w[0][k]);
            w[1][k] = fmaf(y1, s, w[1][k]);
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = i0 + 2 * ty + r;
          float qp = 0.f;
#pragma unroll
          for (int k = 0; k < NPT; ++k) qp = fmaf(SB[(2 * ty + r) * LDN + tx + 16 * k], w[r][k], qp);
          qp = sum16(qp);
          if (i < nq) {
            if (tx == 0) qv[i] = qp;
            float* o = dcp + part + (int64_t)i * N;
#pragma unroll
            for (int k = 0; k < NPT; ++k) {
              const float val = fmaf(ei[i], w[r][k], acc[r][k]);
              o[tx + 16 * k] = g == 0 ? val : o[tx + 16 * k] + val;  // this thread's own entry
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites SB, SX and T1
    }

    // ---- dcums, its reverse cumsum da, ddt and this head's dA term
    if (tid < QMAX)
      dcum[tid] = tid < nq ? rowr[tid] - dts[tid] * colk[tid] + ei[tid] * qv[tid] -
                                 eo[tid] * dts[tid] * uu[tid]
                           : 0.f;
    __syncthreads();
    if (tid < 32) {
      float s = 0.f;
      for (int t = lane; t < nq; t += 32) s = fmaf(eo[t] * dts[t], uu[t], s);
      s = sum32(s);
      float sd = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) sd += wsum[w];
      if (lane == 0) dcum[nq - 1] += expf(clast) * sd + s;
      __syncwarp();
      warp_reverse_cumsum<QMAX>(dcum, lane);
      __syncwarp();
      float sa = 0.f;
      for (int t = lane; t < nq; t += 32) sa = fmaf(dts[t], dcum[t], sa);
      sa = sum32(sa);
      if (lane == 0) dap[((int64_t)b * nc + c) * H + h] = sa;
    }
    __syncthreads();
    if (tid < nq) ddt[(row0 + tid) * H + h] = colk[tid] + eo[tid] * uu[tid] + a * dcum[tid];
    __syncthreads();  // the next head overwrites every shared array
  }
}

// ------------------------------------------------------------ ssd_bwd_reduce
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce(const float* __restrict__ dbp, const float* __restrict__ dcp,
               const float* __restrict__ dap, T* __restrict__ dB, T* __restrict__ dC,
               float* __restrict__ dA, int B, int L, int H, int G, int N, int Q, int bpg) {
  const int nc = (L + Q - 1) / Q;
  if (blockIdx.x == gridDim.x - 1) {  // dA, summed over (b, chunk) in order
    for (int h = threadIdx.x; h < H; h += NT) {
      float s = 0.f;
      for (int bc = 0; bc < B * nc; ++bc) s += dap[(int64_t)bc * H + h];
      dA[h] = s;
    }
    return;
  }
  // dB and dC (B, L, G, N): entry (b, l, grp, n) sums the bpg blocks of group grp
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (int64_t)B * L * G * N) return;
  const int n = (int)(e % N);
  const int64_t gr = e / N;
  const int grp = (int)(gr % G);
  const int64_t row = gr / G;
  const int l = (int)(row % L), b = (int)(row / L);
  const int c = l / Q, t = l % Q;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < bpg; ++k) {
    const int64_t off = ((((int64_t)b * nc + c) * G * bpg + grp * bpg + k) * Q + t) * N + n;
    sb += dbp[off];
    sc += dcp[off];
  }
  dB[e] = from_f32<T>(sb);
  dC[e] = from_f32<T>(sc);
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* s_in, const void* dfinal, void* dx, void* ddt, void* dA,
           void* dB, void* dC, void* dinit, void* ds_end, void* dbp, void* dcp, void* dap, int B,
           int L, int H, int G, int Q, int hg, cudaStream_t stream) {
  constexpr size_t sm_state = state_smem<P, N>(), sm_chunk = chunk_smem<P, N>();
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_state_bwd<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sm_state);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_bwd<T, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_chunk);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (L + Q - 1) / Q, bpg = (H / G + hg - 1) / hg;
  ssd_state_bwd<T, P, N><<<dim3(H, B), NT, sm_state, stream>>>(
      static_cast<const T*>(dy), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Cm), static_cast<const float*>(dfinal), static_cast<float*>(ds_end),
      static_cast<float*>(dinit), L, H, G, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_bwd<T, P, N><<<dim3(G * bpg, nc, B), NT, sm_chunk, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const T*>(dy),
      static_cast<const float*>(s_in), static_cast<const float*>(ds_end), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dbp), static_cast<float*>(dcp),
      static_cast<float*>(dap), L, H, G, Q, hg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)B * L * G * N;
  ssd_bwd_reduce<T><<<(unsigned)((total + NT - 1) / NT + 1), NT, 0, stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), B, L, H, G, N, Q, bpg);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, V>{}) for V in the forward's shapes.
template <class F>
int with_p(int P, F&& f) {
  switch (P) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class F>
int with_n(int N, F&& f) {
  switch (N) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int P, int N, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* dy, const void* s_in, const void* dfinal, void* dx,
             void* ddt, void* dA, void* dB, void* dC, void* dinit, void* ds_end, void* dbp,
             void* dcp, void* dap, int B, int L, int H, int G, int Q, int hg, cudaStream_t st) {
  return with_p(P, [&](auto p) {
    return with_n(N, [&](auto n) {
      return launch<T, decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit, ds_end, dbp, dcp, dap,
          B, L, H, G, Q, hg, st);
    });
  });
}

// ------------------------------------------------- bf16, tensor cores (wgmma)
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int HG_MAX = 8;   // heads per ssd_chunk_bwd_wgmma block, at most (ops.py's _HG_MAX)
constexpr int XSTAGES = 2;  // (x, dy) tiles of one head in ssd_chunk_bwd_wgmma's ring
constexpr int PSTAGES = 2;  // chunks in ssd_state_bwd_wgmma's ring
static_assert(XSTAGES == 2 && PSTAGES >= 2, "a ring holds the tile in use and the next");
// At N <= 64 one step of ssd_chunk_bwd_wgmma per head runs both passes over
// the head's Q x Q matrices, dB and dC accumulating in registers side by
// side; at N = 128 (64 more registers each) every head's first pass runs,
// then every head's second, x and dy read twice.
template <int N>
constexpr bool FUSED_PASSES = N <= 64;

// Sum over the 4 lanes of a quad (the lanes that share an accumulator row),
// in a fixed order: every lane of the quad gets the same bits.
__device__ __forceinline__ float sum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The bf16 pair at (row, col) and (row, col + 1) of a tile of D columns in
// the core-matrix layout (sm90.cuh), col even, as f32.
template <int D>
__device__ __forceinline__ float2 pair_at(const bf16* tile, int row, int col) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      tile + ((row / 8) * (D / 8) + col / 8) * 64 + (row % 8) * 8 + col % 8));
}


// ------------------------------------------------------- ssd_state_bwd_wgmma
template <int Q, int P, int N>
struct StateBwdSlot {  // one chunk of ssd_state_bwd_wgmma's ring
  bf16 dy[Q * P];      // core-matrix layout, rows t
  bf16 c[Q * N];       // core-matrix layout, rows t
  float dt[Q];
};

template <int Q, int P, int N>
constexpr size_t state_bwd_smem() {
  return PSTAGES * sizeof(StateBwdSlot<Q, P, N>) + (4 * Q + 2 * 4) * sizeof(float);
}

template <int Q, int P, int N>
__global__ void __launch_bounds__(128)
ssd_state_bwd_wgmma(const bf16* __restrict__ dy, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Cm,
                    const float* __restrict__ dfinal, const float* __restrict__ s_in,
                    float* __restrict__ ds_end, float* __restrict__ dinit,
                    float* __restrict__ dsdot, int L, int H, int G) {
  using Slot = StateBwdSlot<Q, P, N>;
  constexpr uint32_t GROUP_N = N / 8 * 128;  // bytes between 8-row groups of a C tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Slot* ring = reinterpret_cast<Slot*>(smem_raw);
  float* wts = reinterpret_cast<float*>(smem_raw + PSTAGES * sizeof(Slot));  // 4 x Q
  float* red = wts + 4 * Q;  // 2 x 4: <dS, S> per warp, chunks alternating

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = warp_uniform(tid / 32), lane = tid % 32;
  const int nc = (L + Q - 1) / Q;
  const float a = A[h];
  // Accumulator rows p0 and p0 + 8 (d[4 i + e], e / 2 picks the row), column
  // 8 i + 2 (lane % 4) + e % 2. At P = 32 warps 2 and 3 hold zero rows.
  const int p0 = 16 * warp + lane / 4;
  const bool rows_ok = 16 * warp < P;  // uniform over the warp
  const int64_t st_off = ((int64_t)b * H + h) * P * N;
  const int grp = h / (H / G);  // the group of C this head reads

  auto issue = [&](int k) {  // copies of chunk nc - 1 - k into its slot, as one commit group
    if (k < nc) {
      const int l0 = (nc - 1 - k) * Q, nq = min(Q, L - l0);
      Slot& s = ring[k % PSTAGES];
      load_tile<P, Q, 128>(s.dy, nq, [&](int r) {
        return dy + (((int64_t)b * L + l0 + r) * H + h) * P;
      });
      load_tile<N, Q, 128>(s.c, nq, [&](int r) {
        return Cm + (((int64_t)b * L + l0 + r) * G + grp) * N;
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
      acc[4 * i + e] = dfinal != nullptr && rows_ok ? dfinal[st_off + p * N + n] : 0.f;
    }

#pragma unroll
  for (int k = 0; k < PSTAGES - 1; ++k) issue(k);
  float* w = wts + warp * Q;  // this warp's copy of the chunk's weights
  // <dS, S> of chunk c, summed over the 4 warps in order, to dsdot, where
  // ssd_chunk_bwd_wgmma splits its passes (it reads dS and S as f32 side by
  // side only where it fuses them)
  constexpr bool DOT = !FUSED_PASSES<N>;
  auto put_dot = [&](int k) {
    if (DOT && tid == 0) {
      const float* r = red + 4 * (k % 2);
      dsdot[((int64_t)b * nc + nc - 1 - k) * H + h] = ((r[0] + r[1]) + r[2]) + r[3];
    }
  };
  float2 sv[DOT ? N / 8 : 1][2];  // S at a chunk's start, at this thread's entries of dS
  auto load_sv = [&](int c) {  // in flight while the chunk before computes
    if constexpr (DOT)
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          sv[i][r] = rows_ok ? *reinterpret_cast<const float2*>(
                                   s_in + (((int64_t)b * nc + c) * H + h) * P * N +
                                   (p0 + 8 * r) * N + 8 * i + 2 * (lane % 4))
                             : make_float2(0.f, 0.f);
  };
  load_sv(nc - 1);
  for (int k = 0; k < nc; ++k) {
    const int c = nc - 1 - k, nq = min(Q, L - c * Q);
    const int64_t off = (((int64_t)b * nc + c) * H + h) * P * N;
    cp_async_wait<PSTAGES - 2>();  // this thread's copies of chunk c have landed
    fence_proxy_async();
    __syncthreads();  // everyone's have; every read of chunk c + 1's slot is done
    issue(k + PSTAGES - 1);
    if (k > 0) put_dot(k - 1);
    const Slot& s = ring[k % PSTAGES];

    // weights w_t = exp(cums_t), 0 past L
    const float last = ssd_tc::warp_cumsum_log2<Q>(s.dt, a, w, lane);
#pragma unroll
    for (int kk = 0; kk < Q / 32; ++kk) {
      const int t = lane * (Q / 32) + kk;
      w[t] = t < nq ? fast_exp2(w[t]) : 0.f;
    }
    __syncwarp();

    // dS at the chunk's end and its <dS, S> (f32, in a fixed order), then
    // its decay over the chunk
    if constexpr (DOT) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dot = fmaf(acc[4 * i + 2 * r], sv[i][r].x, dot);
          dot = fmaf(acc[4 * i + 2 * r + 1], sv[i][r].y, dot);
        }
      if (c > 0) load_sv(c - 1);
      dot = sum32(dot);
      if (lane == 0) red[4 * (k % 2) + warp] = dot;
    }
    if (rows_ok) {
      float* so = ds_end + off;
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

    // A = (dy w)^T in bf16: ldmatrix.trans of the dy tile (rows t, columns p),
    // each pair of t scaled by its weights
    uint32_t ya[Q / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      if (rows_ok) {
        const int j = lane / 8;
        const int t = 16 * kk + 8 * (j / 2) + lane % 8, pc = 16 * warp + 8 * (j % 2);
        ldmatrix_x4_trans(ya[kk], s.dy + ((t / 8) * (P / 8) + pc / 8) * 64 + (t % 8) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 wt =
              *reinterpret_cast<const float2*>(w + 16 * kk + 8 * (r / 2) + 2 * (lane % 4));
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ya[kk][r]));
          ya[kk][r] = pack_bf16x2(v.x * wt.x, v.y * wt.y);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) ya[kk][r] = 0u;
      }
    }

    // dS += A . C_c (C_c MN-major: rows t, columns n)
    const uint64_t dc = wgmma_desc(s.c, GROUP_N, 128);
    fence_regs(acc);
    fence_regs(ya);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) wgmma_rs(acc, ya[kk], dc + kk * 2 * GROUP_N / 16, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(ya);
  }
  cp_async_wait<0>();
  __syncthreads();
  put_dot(nc - 1);

  if (dinit != nullptr && rows_ok) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(dinit + st_off + (p0 + 8 * r) * N + 8 * i + 2 * (lane % 4)) =
            make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
  }
}

// ------------------------------------------------------- ssd_chunk_bwd_wgmma

template <int Q, int P, int N>
struct ChunkBwdSmem {
  static constexpr int NSF = FUSED_PASSES<N> ? 2 : 1;  // state tiles a step stages
  bf16 c[Q * N];              // C_c, core-matrix layout, rows i
  bf16 b[Q * N];              // B_c, rows j
  bf16 x[XSTAGES][Q * P];     // x of one head per slot, rows j
  bf16 dy[XSTAGES][Q * P];    // dy of the same head, rows i
  bf16 ds[P * N];             // dS at the chunk's end of the step's head, bf16, rows p
  bf16 s[P * N];              // S at the chunk's start, the same
  float sf[NSF][P * N];       // the next step's state tiles as they land, f32, row-major
  float c2[HG_MAX][Q];        // log2(e) cums per head
  float dt[HG_MAX][Q];        // dt per head (0 past L)
  float colk[HG_MAX][Q];      // sum_i K_ij
  float uu[HG_MAX][Q];        // u_j = x_j . dS B_j
  float rowr[HG_MAX][Q];      // sum_j R_ij, then dcums, then da
  float qv[HG_MAX][Q];        // C_i . S^T dy_i
  float dot[HG_MAX][Q / 16];  // <dS, S> per warp (fused passes)
};

template <int Q, int P, int N>
__global__ void __launch_bounds__(2 * Q, 1)
ssd_chunk_bwd_wgmma(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
                    const float* __restrict__ s_in, const float* __restrict__ ds_end,
                    bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dbp,
                    float* __restrict__ dcp, float* __restrict__ dap, int L, int H, int ngroups,
                    int hg) {
  constexpr int WGS = Q / 64, NT = 128 * WGS, NW = NT / 32;
  constexpr bool FUSED = FUSED_PASSES<N>;
  constexpr uint32_t GROUP_N = N / 8 * 128;  // bytes between 8-row groups, C/B/state tiles
  constexpr uint32_t GROUP_P = P / 8 * 128;  // ... of an x or dy tile
  constexpr int SCH = P * N / 8;             // 16-byte chunks of a bf16 state tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ChunkBwdSmem<Q, P, N>& sm = *reinterpret_cast<ChunkBwdSmem<Q, P, N>*>(smem_raw);

  // the block's heads: HG of its group's rep, the group's last block partial
  const int rep = H / ngroups, bpg = (rep + hg - 1) / hg;  // heads and blocks per group
  const int grp = blockIdx.x / bpg, c = blockIdx.y, b = blockIdx.z;
  const int h0 = grp * rep + (blockIdx.x % bpg) * hg;
  const int nc = gridDim.y;
  const int nh = warp_uniform(min(hg, (grp + 1) * rep - h0));  // heads of this block
  const int nsteps = FUSED ? nh : 2 * nh;
  const int l0 = c * Q, nq = min(Q, L - l0);
  const int tid = threadIdx.x, lane = tid % 32, gw = warp_uniform(tid / 32);
  const int wg = warp_uniform(tid / 128), warp = warp_uniform((tid % 128) / 32);
  const int64_t row0 = (int64_t)b * L + l0;  // the chunk's first row of the sequence
  const int r0 = 64 * wg + 16 * warp + lane / 4;  // this thread's rows r0 and r0 + 8
  const int64_t part = (((int64_t)b * nc + c) * gridDim.x + blockIdx.x) * Q * N;

  load_tile<N, Q, NT>(sm.c, nq, [&](int r) { return Cm + ((row0 + r) * ngroups + grp) * N; });
  load_tile<N, Q, NT>(sm.b, nq, [&](int r) { return Bm + ((row0 + r) * ngroups + grp) * N; });
  // Step s takes head s % nh: x and dy into slot s % XSTAGES and its state
  // tiles into sf (fused: dS, S; else dS in the first pass, S in the
  // second), as one commit group.
  auto issue = [&](int s) {
    if (s < nsteps) {
      const int g = s < nh ? s : s - nh;
      load_tile<P, Q, NT>(sm.x[s % XSTAGES], nq, [&](int r) {
        return x + ((row0 + r) * H + h0 + g) * P;
      });
      load_tile<P, Q, NT>(sm.dy[s % XSTAGES], nq, [&](int r) {
        return dy + ((row0 + r) * H + h0 + g) * P;
      });
      const int64_t st = (((int64_t)b * nc + c) * H + h0 + g) * P * N;
#pragma unroll
      for (int k = 0; k < ChunkBwdSmem<Q, P, N>::NSF; ++k) {
        const float* src = (FUSED ? k == 0 : s < nh) ? ds_end + st : s_in + st;
        for (int i = tid; i < P * N / 4; i += NT) cp_async_16(sm.sf[k] + 4 * i, src + 4 * i, true);
      }
    }
    cp_async_commit();
  };
  issue(0);  // C and B travel with the first step

  // dt of the group's heads (coalesced over heads), then one warp per head
  // takes its cumsum
  for (int i = tid; i < Q * HG_MAX; i += NT) {
    const int t = i / HG_MAX, g = i % HG_MAX;
    sm.dt[g][t] = t < nq && g < nh ? dt[(row0 + t) * H + h0 + g] : 0.f;
  }
  __syncthreads();
  for (int g = gw; g < nh; g += NW)
    ssd_tc::warp_cumsum_log2<Q>(sm.dt[g], A[h0 + g], sm.c2[g], lane);

  // The start of step s: x and dy of its head landed and its state tiles in
  // bf16 in sm.ds and sm.s; then the copies of step s + 1 start.
  // Fused, also this head's <dS, S> per warp in f32 from both f32 tiles.
  auto begin_step = [&](int s) {
    cp_async_wait<0>();  // this thread's copies of step s have landed
    __syncthreads();     // everyone's; every read of the last step's tiles is done
#pragma unroll
    for (int k = 0; k < ChunkBwdSmem<Q, P, N>::NSF; ++k) {
      bf16* dst = (FUSED ? k == 0 : s < nh) ? sm.ds : sm.s;
      for (int i = tid; i < SCH; i += NT) {
        const int r = (i / (8 * (N / 8))) * 8 + i % 8, col = ((i / 8) % (N / 8)) * 8;
        const float4 u0 = *reinterpret_cast<const float4*>(sm.sf[k] + r * N + col);
        const float4 u1 = *reinterpret_cast<const float4*>(sm.sf[k] + r * N + col + 4);
        reinterpret_cast<uint4*>(dst)[i] =
            make_uint4(pack_bf16x2(u0.x, u0.y), pack_bf16x2(u0.z, u0.w),
                       pack_bf16x2(u1.x, u1.y), pack_bf16x2(u1.z, u1.w));
      }
    }
    if constexpr (FUSED) {
      float dotp = 0.f;
      for (int i = tid; i < P * N; i += NT) dotp = fmaf(sm.sf[0][i], sm.sf[1][i], dotp);
      dotp = sum32(dotp);
      if (lane == 0) sm.dot[s][gw] = dotp;
    }
    fence_proxy_async();  // the async proxy (wgmma) reads what this thread wrote
    __syncthreads();      // sm.ds and sm.s are whole, sm.sf free
    issue(s + 1);
  };

  const uint64_t d_c = wgmma_desc(sm.c, 128, GROUP_N);    // C K-major (rows i)
  const uint64_t d_b = wgmma_desc(sm.b, 128, GROUP_N);    // B K-major (rows j)
  const uint64_t d_ct = wgmma_desc(sm.c, GROUP_N, 128);   // C MN-major (rows i along K)
  const uint64_t d_bt = wgmma_desc(sm.b, GROUP_N, 128);   // B MN-major (rows j along K)
  const uint64_t d_ds = wgmma_desc(sm.ds, 128, GROUP_N);  // dS K-major (rows p along N)
  const uint64_t d_dst = wgmma_desc(sm.ds, GROUP_N, 128); // dS MN-major (rows p along K)
  const uint64_t d_sst = wgmma_desc(sm.s, GROUP_N, 128);  // S MN-major (rows p along K)
  const uint64_t blk_n = 8 * GROUP_N / 16, blk_p = 8 * GROUP_P / 16;  // 64 rows of a tile
  const uint64_t kst_n = 2 * GROUP_N / 16, kst_p = 2 * GROUP_P / 16;  // 16 rows, MN-major

  // ---- the first pass over head g, transposed: this warpgroup's rows j;
  // dx, u, the column sums of K, and dB summed into db
  auto pass1 = [&](int g, int slot, float (&db)[N / 2]) {
    const float* c2 = sm.c2[g];
    const float* dtg = sm.dt[g];
    const bf16* xs = sm.x[slot];
    const uint64_t d_x = wgmma_desc(xs, 128, GROUP_P);
    const uint64_t d_y = wgmma_desc(sm.dy[slot], 128, GROUP_P);
    const uint64_t d_yt = wgmma_desc(sm.dy[slot], GROUP_P, 128);
    const float cj[2] = {c2[r0], c2[r0 + 8]}, dtj[2] = {dtg[r0], dtg[r0 + 8]};
    const float clast = c2[Q - 1];

    // v = B dS^T (rows j, columns p), z = x dS (rows j, columns n)
    float v[P / 2], z[N / 2];
    fence_regs(v);
    fence_regs(z);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss(v, d_b + wg * blk_n + 16 * kk, d_ds + 16 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss_tb(z, d_x + wg * blk_p + 16 * kk, d_dst + kk * kst_n, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(v);
    fence_regs(z);

    // u_j = x_j . v_j; v_j scaled by exp(cums_last - cums_j) (dx's state
    // term); dB_j += exp(cums_last - cums_j) dt_j z_j
    const float eo[2] = {fast_exp2(clast - cj[0]), fast_exp2(clast - cj[1])};
    float up[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 xv = pair_at<P>(xs, r0 + 8 * r, 8 * i + 2 * (lane % 4));
        up[r] = fmaf(xv.x, v[4 * i + 2 * r], up[r]);
        up[r] = fmaf(xv.y, v[4 * i + 2 * r + 1], up[r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      up[r] = sum4(up[r]);
      if (lane % 4 == 0) sm.uu[g][r0 + 8 * r] = up[r];
    }
#pragma unroll
    for (int i = 0; i < P / 2; ++i) v[i] *= eo[(i % 4) / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) db[i] = fmaf(eo[(i % 4) / 2] * dtj[(i % 4) / 2], z[i], db[i]);

    // the column blocks of i this warpgroup's rows see (i >= j): G^T = B C^T
    // and (dy.x^T)^T = x dy^T, then M^T = G^T E^T and dG^T = (x dy^T) E^T
    // dt_j in bf16 as A operands of dx += M^T dy and dB += dG^T C; the row
    // sums of K^T = M^T (x dy^T) in f32
    float colp[2] = {0.f, 0.f};
#pragma unroll
    for (int cb = 0; cb < WGS; ++cb) {
      if (cb >= wg) {
        float G[32], D[32];
        fence_regs(G);
        fence_regs(D);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          wgmma_ss(G, d_b + wg * blk_n + 16 * kk, d_c + cb * blk_n + 16 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          wgmma_ss(D, d_x + wg * blk_p + 16 * kk, d_y + cb * blk_p + 16 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(G);
        fence_regs(D);

        // Of the block on the diagonal (cb = wg), this warp's 16 rows see
        // the 8-column groups ii > 2 warp + 1, part of 2 warp and 2 warp + 1
        // (masked by a select) and none before them (zero, no exp).
        uint32_t ma[4][4], ga[4][4];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int col = 64 * cb + 8 * ii + 2 * (lane % 4);
          const int vis = cb > wg ? 2 : ii - 2 * warp;  // < 0: none, 0 or 1: masked, 2: all
          float mv[4] = {0.f, 0.f, 0.f, 0.f}, gv[4] = {0.f, 0.f, 0.f, 0.f};
          if (vis >= 0) {  // uniform over the warp
            const float2 ci = *reinterpret_cast<const float2*>(c2 + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool seen = vis > 1 || col + e % 2 >= r0 + 8 * (e / 2);
              const float ev = seen ? fast_exp2((e % 2 ? ci.y : ci.x) - cj[e / 2]) : 0.f;
              mv[e] = G[4 * ii + e] * ev;
              gv[e] = D[4 * ii + e] * ev * dtj[e / 2];
              colp[e / 2] = fmaf(mv[e], D[4 * ii + e], colp[e / 2]);
            }
          }
          ma[ii / 2][2 * (ii % 2)] = pack_bf16x2(mv[0], mv[1]);
          ma[ii / 2][2 * (ii % 2) + 1] = pack_bf16x2(mv[2], mv[3]);
          ga[ii / 2][2 * (ii % 2)] = pack_bf16x2(gv[0], gv[1]);
          ga[ii / 2][2 * (ii % 2) + 1] = pack_bf16x2(gv[2], gv[3]);
        }
        fence_regs(v);
        fence_regs(db);
        fence_regs(ma);
        fence_regs(ga);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(v, ma[kk], d_yt + (4 * cb + kk) * kst_p, 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(db, ga[kk], d_ct + (4 * cb + kk) * kst_n, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(v);
        fence_regs(db);
        fence_regs(ma);
        fence_regs(ga);
      }
    }

    // dx_j = dt_j (M^T dy + exp(cums_last - cums_j) dS B_j)_j; sum_i K_ij
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      colp[r] = sum4(colp[r]);
      if (lane % 4 == 0) sm.colk[g][row] = colp[r];
      if (row < nq) {
        bf16* dst = dx + ((row0 + row) * H + h0 + g) * P + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < P / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
              __floats2bfloat162_rn(v[4 * i + 2 * r] * dtj[r], v[4 * i + 2 * r + 1] * dtj[r]);
      }
    }
  };

  // ---- the second pass over head g, as the forward: this warpgroup's rows
  // i; qv and the row sums of R, and dC summed into dcc
  auto pass2 = [&](int g, int slot, float (&dcc)[N / 2]) {
    const float* c2 = sm.c2[g];
    const float* dtg = sm.dt[g];
    const bf16* xs = sm.x[slot];
    const uint64_t d_x = wgmma_desc(xs, 128, GROUP_P);
    const uint64_t d_y = wgmma_desc(sm.dy[slot], 128, GROUP_P);
    const float ci[2] = {c2[r0], c2[r0 + 8]};

    // w = dy S (rows i, columns n); qv_i = C_i . w_i; dC_i += exp(cums_i) w_i
    float w[N / 2];
    fence_regs(w);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss_tb(w, d_y + wg * blk_p + 16 * kk, d_sst + kk * kst_n, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(w);
    const float ei[2] = {fast_exp2(ci[0]), fast_exp2(ci[1])};
    float qp[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 cv = pair_at<N>(sm.c, r0 + 8 * r, 8 * i + 2 * (lane % 4));
        qp[r] = fmaf(cv.x, w[4 * i + 2 * r], qp[r]);
        qp[r] = fmaf(cv.y, w[4 * i + 2 * r + 1], qp[r]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qp[r] = sum4(qp[r]);
      if (lane % 4 == 0) sm.qv[g][r0 + 8 * r] = qp[r];
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) dcc[i] = fmaf(ei[(i % 4) / 2], w[i], dcc[i]);

    // the column blocks of j this warpgroup's rows see (j <= i): G = C B^T
    // and dy x^T, then dG = (dy x^T) E dt_j in bf16 as the A operand of
    // dC += dG B; the row sums of R = G E (dy x^T) dt_j in f32
    float rp[2] = {0.f, 0.f};
#pragma unroll
    for (int cb = 0; cb < WGS; ++cb) {
      if (cb <= wg) {
        float G[32], D[32];
        fence_regs(G);
        fence_regs(D);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          wgmma_ss(G, d_c + wg * blk_n + 16 * kk, d_b + cb * blk_n + 16 * kk, kk > 0);
#pragma unroll
        for (int kk = 0; kk < P / 16; ++kk)
          wgmma_ss(D, d_y + wg * blk_p + 16 * kk, d_x + cb * blk_p + 16 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(G);
        fence_regs(D);

        // Of the block on the diagonal (cb = wg), this warp's 16 rows see
        // the 8-column groups ii < 2 warp, part of 2 warp and 2 warp + 1
        // (masked by a select) and none past them (zero, no exp).
        uint32_t ga[4][4];
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int col = 64 * cb + 8 * ii + 2 * (lane % 4);
          const int vis = cb < wg ? -1 : ii - 2 * warp;  // < 0: all, 0 or 1: masked, > 1: none
          float gv[4] = {0.f, 0.f, 0.f, 0.f};
          if (vis <= 1) {  // uniform over the warp
            const float2 cj = *reinterpret_cast<const float2*>(c2 + col);
            const float2 dj = *reinterpret_cast<const float2*>(dtg + col);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool seen = vis < 0 || col + e % 2 <= r0 + 8 * (e / 2);
              const float ev = seen ? fast_exp2(ci[e / 2] - (e % 2 ? cj.y : cj.x)) : 0.f;
              const float de = D[4 * ii + e] * ev, djv = e % 2 ? dj.y : dj.x;
              gv[e] = de * djv;
              rp[e / 2] = fmaf(G[4 * ii + e] * de, djv, rp[e / 2]);
            }
          }
          ga[ii / 2][2 * (ii % 2)] = pack_bf16x2(gv[0], gv[1]);
          ga[ii / 2][2 * (ii % 2) + 1] = pack_bf16x2(gv[2], gv[3]);
        }
        fence_regs(dcc);
        fence_regs(ga);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(dcc, ga[kk], d_bt + (4 * cb + kk) * kst_n, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dcc);
        fence_regs(ga);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rp[r] = sum4(rp[r]);
      if (lane % 4 == 0) sm.rowr[g][r0 + 8 * r] = rp[r];
    }
  };

  // one f32 partial per block of dB or dC over the group's heads, each entry
  // this thread's own
  auto put_part = [&](float* dst0, const float (&acc)[N / 2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < nq) {
        float* dst = dst0 + part + (int64_t)row * N + 2 * (lane % 4);
#pragma unroll
        for (int i = 0; i < N / 8; ++i)
          *reinterpret_cast<float2*>(dst + 8 * i) =
              make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
      }
    }
  };
  if constexpr (FUSED) {
    float db[N / 2] = {}, dcc[N / 2] = {};
    for (int g = 0; g < nh; ++g) {
      begin_step(g);
      pass1(g, g % XSTAGES, db);
      pass2(g, g % XSTAGES, dcc);
    }
    put_part(dbp, db);
    put_part(dcp, dcc);
  } else {
    {
      float db[N / 2] = {};
      for (int g = 0; g < nh; ++g) {
        begin_step(g);
        pass1(g, g % XSTAGES, db);
      }
      put_part(dbp, db);
    }
    float dcc[N / 2] = {};
    for (int g = 0; g < nh; ++g) {
      begin_step(nh + g);
      pass2(g, (nh + g) % XSTAGES, dcc);
    }
    put_part(dcp, dcc);
  }
  cp_async_wait<0>();  // no copy outlives the block (the ring's last groups are empty)
  __syncthreads();     // every head's sums are in shared memory

  // ---- dcums, its reverse cumsum da, ddt and dA of each head, one warp per head
  for (int g = gw; g < nh; g += NW) {
    float* dcum = sm.rowr[g];
    const float* c2 = sm.c2[g];
    const float* dtg = sm.dt[g];
    const float clast = c2[Q - 1];
    float su = 0.f;
    for (int t = lane; t < Q; t += 32) {
      float v = 0.f;
      if (t < nq) {
        const float eo = fast_exp2(clast - c2[t]);
        v = dcum[t] - dtg[t] * sm.colk[g][t] + fast_exp2(c2[t]) * sm.qv[g][t] -
            eo * dtg[t] * sm.uu[g][t];
        su = fmaf(eo * dtg[t], sm.uu[g][t], su);
      }
      dcum[t] = v;
    }
    su = sum32(su);
    // <dS, S>: fused, from the warps' partials; else the state pass's, in
    // dap until replaced below
    float* da_part = dap + ((int64_t)b * nc + c) * H + h0 + g;
    float sd = 0.f;
    if constexpr (FUSED) {
#pragma unroll
      for (int w = 0; w < NW; ++w) sd += sm.dot[g][w];
    } else {
      sd = *da_part;
    }
    __syncwarp();
    if (lane == 0) dcum[nq - 1] += fast_exp2(clast) * sd + su;
    __syncwarp();
    warp_reverse_cumsum<Q>(dcum, lane);
    __syncwarp();
    const float a = A[h0 + g];
    float sa = 0.f;
    for (int t = lane; t < nq; t += 32) {
      sa = fmaf(dtg[t], dcum[t], sa);
      ddt[(row0 + t) * H + h0 + g] =
          sm.colk[g][t] + fast_exp2(clast - c2[t]) * sm.uu[g][t] + a * dcum[t];
    }
    sa = sum32(sa);
    if (lane == 0) *da_part = sa;
  }
}

template <int Q, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* s_in, const void* dfinal, void* dx, void* ddt, void* dA,
           void* dB, void* dC, void* dinit, void* ds_end, void* dbp, void* dcp, void* dap, int B,
           int L, int H, int G, int hg, cudaStream_t stream) {
  constexpr size_t sm_state = state_bwd_smem<Q, P, N>(), sm_chunk = sizeof(ChunkBwdSmem<Q, P, N>);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(ssd_state_bwd_wgmma<Q, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sm_state);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_bwd_wgmma<Q, P, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_chunk);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int nc = (L + Q - 1) / Q, bpg = (H / G + hg - 1) / hg;
  ssd_state_bwd_wgmma<Q, P, N><<<dim3(H, B), 128, sm_state, stream>>>(
      static_cast<const bf16*>(dy), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Cm), static_cast<const float*>(dfinal),
      static_cast<const float*>(s_in), static_cast<float*>(ds_end), static_cast<float*>(dinit),
      static_cast<float*>(dap), L, H, G);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_bwd_wgmma<Q, P, N><<<dim3(G * bpg, nc, B), 2 * Q, sm_chunk, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(s_in), static_cast<const float*>(ds_end), static_cast<bf16*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dbp), static_cast<float*>(dcp),
      static_cast<float*>(dap), L, H, G, hg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)B * L * G * N;
  ssd_bwd_reduce<bf16><<<(unsigned)((total + NT - 1) / NT + 1), NT, 0, stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<bf16*>(dB), static_cast<bf16*>(dC),
      static_cast<float*>(dA), B, L, H, G, N, Q, bpg);
  return (int)cudaGetLastError();
}

// Calls f(std::integral_constant<int, V>{}) for V in the route's state dims.
template <class F>
int with_tc_n(int N, F&& f) {
  switch (N) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int P, int N, int Q, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* dy, const void* s_in, const void* dfinal, void* dx,
             void* ddt, void* dA, void* dB, void* dC, void* dinit, void* ds_end, void* dbp,
             void* dcp, void* dap, int B, int L, int H, int G, int hg, cudaStream_t st) {
  if (hg > HG_MAX) return (int)cudaErrorInvalidValue;
  auto go = [&](auto q, auto p) {
    return with_tc_n(N, [&](auto n) {
      return launch<decltype(q)::value, decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit, ds_end, dbp, dcp, dap,
          B, L, H, G, hg, st);
    });
  };
  using I32 = std::integral_constant<int, 32>;
  using I64 = std::integral_constant<int, 64>;
  using I128 = std::integral_constant<int, 128>;
  if (Q == 64 && P == 32) return go(I64{}, I32{});
  if (Q == 64 && P == 64) return go(I64{}, I64{});
  if (Q == 128 && P == 32) return go(I128{}, I32{});
  if (Q == 128 && P == 64) return go(I128{}, I64{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x, dy, dx (B, L, H, P), dt, ddt (B, L, H) f32, A, dA (H,) f32, Bm, Cm, dB,
// dC (B, L, G, N) with H a multiple of G (head h reads group h / (H / G)),
// s_in (B, NC, H, P, N) f32 (the forward's state at every chunk start),
// dfinal (B, H, P, N) f32 or null (zeros), dinit (B, H, P, N) f32 or
// null (not written); x, Bm, Cm, dy and the gradients dx, dB, dC in dtype
// (0 = float32, 1 = bfloat16); all contiguous, on the stream's device;
// chunks of 1 <= Q <= 128 rows, NC = ceil(L / Q). hg: heads per block of the
// chunk kernels, at most H / G (ssd_scan/ops.py::_head_group). Scratch, f32:
// ds_end (B, NC, H, P, N), dbp and dcp (B, NC, G ceil(H / G / hg), Q, N), dap
// (B, NC, H).
// route 1 is the tensor-core route, which takes bf16 with Q in {64, 128},
// P in {32, 64}, N in {32, 64, 128} and hg <= 8 (ssd_scan/ops.py::route)
// and launches ssd_state_bwd_wgmma, ssd_chunk_bwd_wgmma and ssd_bwd_reduce;
// route 0 the scalar kernels ssd_state_bwd, ssd_chunk_bwd and
// ssd_bwd_reduce, in either dtype. Returns the first failed launch's
// cudaError_t, else 0.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* dy, const void* s_in,
                                  const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* dinit, void* ds_end, void* dbp, void* dcp,
                                  void* dap, int B, int L, int H, int G, int P, int N, int Q,
                                  int hg, int dtype, int route, void* stream) {
  if (Q < 1 || Q > QMAX || L < 1 || hg < 1 || G < 1 || H % G || hg > H / G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return tc::dispatch(P, N, Q, x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit,
                        ds_end, dbp, dcp, dap, B, L, H, G, hg, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(P, N, x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit,
                           ds_end, dbp, dcp, dap, B, L, H, G, Q, hg, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC,
                                   dinit, ds_end, dbp, dcp, dap, B, L, H, G, Q, hg, s);
  return (int)cudaErrorInvalidValue;
}
