// Backward of the Mamba2 SSD chunked scan (ssd_scan.cu, ngroups = 1), for
// Hopper.
//
// Replaces what the reference gets from XLA's autodiff of its plain scan
// (src/repro/models/ssm.py::ssd_chunked): the TPU kernel src/repro/kernels/
// ssd_scan/kernel.py has no gradient, and the reference trains on the plain
// scan. Per (batch b, head h) and chunk of Q rows, with a = dt A, cums its
// inclusive cumsum in the chunk, last its last row, G = C B^T (shared by
// every head), E_ij = exp(cums_i - cums_j) for j <= i (else 0), M = G E, S
// the state at the chunk's start (S_in, saved by the forward) and dS the
// gradient of the state at its end:
//   dS_start = exp(cums_last) dS + sum_i exp(cums_i) dy_i C_i^T
//   dx_j = dt_j (sum_i M_ij dy_i + exp(cums_last - cums_j) dS B_j)
//   dC_i = sum_j dG_ij B_j + exp(cums_i) S^T dy_i,  dG_ij = (dy_i . x_j) dt_j E_ij
//   dB_j = sum_i dG_ij C_i + exp(cums_last - cums_j) dt_j dS^T x_j
//   ddt_j = sum_i M_ij (dy_i . x_j) + exp(cums_last - cums_j) u_j + A da_j,
//     u_j = x_j . dS B_j,
// dB and dC summed over the heads, da the reverse cumsum in the chunk of
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
// for all heads. At zamba2-2.7b's training microbatch (B = 4, L = 2048,
// H = 80, P = N = 64, Q = 128, bf16) that is ~7.5e10 operations against
// ~0.35 GB: bound by bytes (0.10 ms at 3.35 TB/s), as the forward.
//
// Three kernels, one C call, deterministic: no atomics, and every sum runs
// in a fixed order, so two calls on the same inputs give the same bits.
// One route for both dtypes, scalar f32 FMAs from f32 shared tiles (bf16
// inputs are widened as they land, so the bf16 route rounds nothing but its
// outputs dx, dB and dC): a simple kernel first; tensor cores for the
// Q x Q and Q x (P | N) products, as in ssd_chunk_out, are ROADMAP B3.
// 256 threads as a 16 x 16 grid (ty, tx); tiles have odd row strides.
//
// (a) ssd_state_bwd, grid (H, B): the only sequential part. One block per
//     (b, h) walks the chunks last to first, carrying dS (P x N, f32) in
//     registers (entries (ty P/16 + i, tx + 16 c), as the forward's state):
//     at each chunk it writes dS (the gradient at the chunk's end) to the f32
//     scratch dS_end (B, NC, H, P, N), then folds the chunk in. dinit is the
//     last dS.
// (b) ssd_chunk_bwd, grid (ceil(H / HG), NC, B): every chunk at once, HG
//     heads per block in turn. Per head two passes over the lower triangle
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
//     per head group (B, NC, ceil(H / HG), Q, N), each entry owned by one
//     thread for every head of the block (read, add, write: no barrier, no
//     atomic); dA to a partial per (b, chunk, head). Shared memory: C or B
//     and dy or x whole, dS or S, two tiles: 140 KB at P = N = 64, 198 KB at
//     P = 64, N = 128 (mamba2-130m), one block per SM.
// (c) ssd_bwd_reduce: dB and dC summed over the head groups in order and
//     rounded to x's dtype; dA summed over (b, chunk) in order by the last
//     block.
//
// Rows past L are zero-filled and dt there is 0, so they reach no gradient,
// and no gradient is written for them.

#include "common.cuh"

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

// In place, by one warp: v[t] <- sum_{i >= t} v[i] over [0, QMAX).
__device__ __forceinline__ void warp_reverse_cumsum(float* v, int lane) {
  constexpr int PER = QMAX / 32;
  float part[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += v[QMAX - 1 - (lane * PER + k)];
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
  for (int k = 0; k < PER; ++k) v[QMAX - 1 - (lane * PER + k)] = incl - run + part[k];
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
              float* __restrict__ ds_end, float* __restrict__ dinit, int L, int H, int Q) {
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
      ct.load(Cm + ((int64_t)b * L + l0) * N, N, nq);
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
              float* __restrict__ dcp, float* __restrict__ dap, int L, int H, int Q, int hg) {
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

  const int h0 = blockIdx.x * hg, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int nh = min(hg, H - h0);
  const int l0 = c * Q, nq = min(Q, L - l0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16, lane = tid % 32, warp = tid / 32;
  const int64_t row0 = (int64_t)b * L + l0;  // the chunk's first row of the sequence
  const int64_t part = (((int64_t)b * nc + c) * gridDim.x + blockIdx.x) * Q * N;

  for (int g = 0; g < nh; ++g) {
    const int h = h0 + g;
    const float a = A[h];
    const int64_t st = (((int64_t)b * nc + c) * H + h) * P * N;

    if (tid < QMAX) dts[tid] = tid < nq ? dt[(row0 + tid) * H + h] : 0.f;
    {
      RowTile<T, N, QMAX, NT> ct;
      ct.load(Cm + row0 * N, N, nq);
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
        bt.load(Bm + (row0 + j0) * N, N, nj);
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
      bt.load(Bm + row0 * N, N, nq);
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
        ctile.load(Cm + (row0 + i0) * N, N, ni);
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
      warp_reverse_cumsum(dcum, lane);
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
               float* __restrict__ dA, int B, int L, int H, int N, int Q, int ng) {
  const int nc = (L + Q - 1) / Q;
  if (blockIdx.x == gridDim.x - 1) {  // dA, summed over (b, chunk) in order
    for (int h = threadIdx.x; h < H; h += NT) {
      float s = 0.f;
      for (int bc = 0; bc < B * nc; ++bc) s += dap[(int64_t)bc * H + h];
      dA[h] = s;
    }
    return;
  }
  const int64_t e = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (e >= (int64_t)B * L * N) return;
  const int n = (int)(e % N);
  const int64_t row = e / N;
  const int l = (int)(row % L), b = (int)(row / L);
  const int c = l / Q, t = l % Q;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < ng; ++g) {
    const int64_t off = ((((int64_t)b * nc + c) * ng + g) * Q + t) * N + n;
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
           int L, int H, int Q, int hg, cudaStream_t stream) {
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
  const int nc = (L + Q - 1) / Q, ng = (H + hg - 1) / hg;
  ssd_state_bwd<T, P, N><<<dim3(H, B), NT, sm_state, stream>>>(
      static_cast<const T*>(dy), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Cm), static_cast<const float*>(dfinal), static_cast<float*>(ds_end),
      static_cast<float*>(dinit), L, H, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_bwd<T, P, N><<<dim3(ng, nc, B), NT, sm_chunk, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const T*>(dy),
      static_cast<const float*>(s_in), static_cast<const float*>(ds_end), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dbp), static_cast<float*>(dcp),
      static_cast<float*>(dap), L, H, Q, hg);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)B * L * N;
  ssd_bwd_reduce<T><<<(unsigned)((total + NT - 1) / NT + 1), NT, 0, stream>>>(
      static_cast<const float*>(dbp), static_cast<const float*>(dcp),
      static_cast<const float*>(dap), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), B, L, H, N, Q, ng);
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
             void* dcp, void* dap, int B, int L, int H, int Q, int hg, cudaStream_t st) {
  return with_p(P, [&](auto p) {
    return with_n(N, [&](auto n) {
      return launch<T, decltype(p)::value, decltype(n)::value>(
          x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit, ds_end, dbp, dcp, dap,
          B, L, H, Q, hg, st);
    });
  });
}

}  // namespace

// x, dy, dx (B, L, H, P), dt, ddt (B, L, H) f32, A, dA (H,) f32, Bm, Cm, dB,
// dC (B, L, N), s_in (B, NC, H, P, N) f32 (the forward's state at every chunk
// start), dfinal (B, H, P, N) f32 or null (zeros), dinit (B, H, P, N) f32 or
// null (not written); x, Bm, Cm, dy and the gradients dx, dB, dC in dtype
// (0 = float32, 1 = bfloat16); all contiguous, on the stream's device;
// chunks of 1 <= Q <= 128 rows, NC = ceil(L / Q). Scratch, f32: ds_end
// (B, NC, H, P, N), dbp and dcp (B, NC, ceil(H / hg), Q, N), dap (B, NC, H).
// Launches ssd_state_bwd, ssd_chunk_bwd and ssd_bwd_reduce; returns the
// first failed launch's cudaError_t, else 0.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                  const void* Cm, const void* dy, const void* s_in,
                                  const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                                  void* dC, void* dinit, void* ds_end, void* dbp, void* dcp,
                                  void* dap, int B, int L, int H, int P, int N, int Q, int hg,
                                  int dtype, void* stream) {
  if (Q < 1 || Q > QMAX || L < 1 || hg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, N, x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC, dinit,
                           ds_end, dbp, dcp, dap, B, L, H, Q, hg, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, dy, s_in, dfinal, dx, ddt, dA, dB, dC,
                                   dinit, ds_end, dbp, dcp, dap, B, L, H, Q, hg, s);
  return (int)cudaErrorInvalidValue;
}
