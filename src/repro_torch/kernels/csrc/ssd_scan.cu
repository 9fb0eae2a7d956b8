// Mamba2 SSD chunked scan (state-space duality, ngroups = 1) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (ssd_scan,
// body _ssd_kernel), whose oracle is src/repro/models/ssm.py::ssd_chunked.
// Per (batch b, head h) the sequence runs in chunks of Q rows. With
// dA = dt * A and cums its inclusive cumsum within the chunk:
//   y[i]    = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//             + exp(cums_i) (C_i . state)                         (P values)
//   state' = state exp(cums_last) + sum_t exp(cums_last - cums_t) dt_t x_t B_t^T
// B and C (one group) are shared by every head.
//
// What bounds it on the card: per (b, h, chunk) the work is 2 Q^2 N
// (C B^T) + 2 Q^2 P (scores . x dt) + 4 Q N P (C state^T, state increment)
// operations, against x and y read and written once and B and C read once
// for all heads. At zamba2-2.7b's serving shapes (Q = 128, P = 64, N = 64,
// bf16) that is about 190 operations per byte, below the H100's ~295, so
// the function is bound by bytes. This first version runs the products as
// f32 FMAs from shared memory (no tensor cores), so the f32 FMA rate, not
// the bytes, limits it, and it reads B and C once per head; wgmma, TMA and
// sharing B/C tiles across heads are for a later PR.
//
// Design. One block owns one (b, h) and loops over the chunks in order: the
// TPU kernel's sequential chunk grid axis and its VMEM state scratch become
// that loop and a (P, N) f32 state in shared memory. A chunk's x, B and C
// are loaded into f32 tiles (ragged rows past L zero-filled, never read),
// x is scaled by dt in place, one warp takes the cumsum of dA, and dA of
// the rows past L is 0, so they reach neither y nor the state. The
// Q x Q score matrix does not fit beside the tiles (at Q = N = 128, P = 64
// the f32 tiles of x, B, C and the state take 176 KiB of the 227 KiB a
// block may use), so the intra-chunk product runs RB = 32 query rows at a
// time over a 32 x Q score tile, and only over the columns j < the tile's
// last row + 1. exp(cums_i - cums_j) is evaluated only where j <= i: above
// the diagonal it can overflow (dA < 0), and a mask applied by multiplying
// would turn inf * 0 into NaN. 256 threads as a 16 x 16 grid (ty, tx):
// score columns tx + 16 c, output columns tx + 16 e, state entries
// (ty * P/16 + i, tx + 16 c). Tiles have an odd row stride so that the 16
// rows a half-warp reads fall in 16 different banks. At B * H blocks
// (48 for mamba2-130m at B = 2, 160 for zamba2-2.7b) of one block per SM,
// a small batch leaves SMs idle; splitting heads or chunks is for later.

#include "common.cuh"

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
                T* __restrict__ y, float* __restrict__ final_state, int L, int H, int Q) {
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

  for (int i = tid; i < P * N; i += NT)
    Ss[(i / N) * LDN + i % N] = init_state != nullptr ? init_state[state_off + i] : 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    const int nq = min(Q, L - l0);
    {
      RowTile<T, P, QMAX, NT> xt;
      xt.load(x + (((int64_t)b * L + l0) * H + h) * P, (int64_t)H * P, nq);
      xt.store(Xs, LDP);
    }
    {
      RowTile<T, N, QMAX, NT> bt;
      bt.load(Bm + ((int64_t)b * L + l0) * N, N, nq);
      bt.store(Bs, LDN);
    }
    {
      RowTile<T, N, QMAX, NT> ct;
      ct.load(Cm + ((int64_t)b * L + l0) * N, N, nq);
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
           const void* init_state, void* y, void* final_state, int B, int L, int H, int Q,
           cudaStream_t stream) {
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
      static_cast<float*>(final_state), L, H, Q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(int N, const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* s0, void* y, void* fs, int B, int L, int H, int Q,
               cudaStream_t st) {
  switch (N) {
    case 16: return launch<T, P, 16>(x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    case 32: return launch<T, P, 32>(x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    case 64: return launch<T, P, 64>(x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    case 128: return launch<T, P, 128>(x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int P, int N, const void* x, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* s0, void* y, void* fs, int B, int L, int H, int Q,
             cudaStream_t st) {
  switch (P) {
    case 16: return dispatch_n<T, 16>(N, x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    case 32: return dispatch_n<T, 32>(N, x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    case 64: return dispatch_n<T, 64>(N, x, dt, A, Bm, Cm, s0, y, fs, B, L, H, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B, L, H, P), dt (B, L, H) f32, A (H,) f32, Bm/Cm (B, L, N), init_state
// (B, H, P, N) f32 or null (zeros), y (B, L, H, P), final_state (B, H, P, N)
// f32; all contiguous, on the stream's device; chunks of 1 <= Q <= 128 rows.
// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16. Returns the launch's
// cudaError_t.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* init_state, void* y,
                              void* final_state, int B, int L, int H, int P, int N, int Q,
                              int dtype, void* stream) {
  if (Q < 1 || Q > QMAX || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(P, N, x, dt, A, Bm, Cm, init_state, y, final_state, B, L, H, Q, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(P, N, x, dt, A, Bm, Cm, init_state, y, final_state, B, L,
                                   H, Q, s);
  return (int)cudaErrorInvalidValue;
}
