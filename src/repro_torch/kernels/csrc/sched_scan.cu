// The sequential scans of the Kairos schedulers as device programs, one
// thread block each.
//
// Replaces the two jax.lax.scan loops of src/repro/core/jax_sched.py (not
// Pallas kernels; the rest of those schedulers is tensor code in
// repro_torch/core/device_sched.py):
//   fcfs_scan   the FCFS max-plus recurrence of fcfs_finish_times
//               (Algorithm 2, jax_sched.py:44-49): over slots sorted by
//               arrival, t_i = max(t_{i-1}, a_i) + d_i from t_now;
//   slack_pack  the greedy packing walk of slack_select (Algorithm 3,
//               jax_sched.py:144-156): over slots sorted by sequence length,
//               slot i joins when it is active, t_step = LUT[count + 1,
//               seq_i] <= s_min, and (count + 1) * t_cur > count * t_step
//               (or the batch is empty).
//
// What bounds it on the card: neither bytes (12 bytes a slot) nor
// operations (a handful a slot), but the chain of dependent steps: each
// step reads the carry the one before wrote, and the reference's f32
// rounding fixes the order (a parallel max-plus scan would round its sums
// in another order). So the walk is one thread's latency chain, some tens
// of cycles a slot out of shared memory.
//
// Design: one block of NT threads. Per tile of TILE slots the threads stage
// the inputs from device memory into shared memory with coalesced loads
// (the pack also computes each slot's sequence bucket there, which does
// not depend on the walk), thread 0 walks the tile in the reference's
// order with the reference's arithmetic (IEEE round-to-nearest adds and
// multiplies, no contraction into FMAs; a NaN-propagating max, as
// jnp.maximum and torch.maximum), and the threads write the tile's results
// back. The pack keeps the LUT and its bucket edges in shared memory, and
// recomputes the batch-size bucket only when the batch grows. The result is
// bit for bit the plain version's (sched_scan/ref.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int TILE = 2048;
constexpr int MAX_LUT = 4096;   // NB * NS floats of the step-time table
constexpr int MAX_EDGES = 256;  // bucket edges per axis

__device__ __forceinline__ float max_nan(float x, float y) {
  return (isnan(x) || isnan(y)) ? NAN : fmaxf(x, y);
}

// clip(searchsorted(edges, x, side="right") - 1, 0, n - 1) over ascending edges
__device__ __forceinline__ int bucket(const int* edges, int n, int x) {
  int lo = 0, hi = n;  // first index with edges[i] > x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return min(max(lo - 1, 0), n - 1);
}

__global__ void __launch_bounds__(NT) fcfs_scan_kernel(const float* __restrict__ a,
                                                       const float* __restrict__ d,
                                                       const float* __restrict__ t0,
                                                       float* __restrict__ out, int n) {
  __shared__ float sa[TILE], sd[TILE];
  float t = 0.f;  // the carry, in thread 0
  if (threadIdx.x == 0) t = *t0;
  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    for (int i = threadIdx.x; i < m; i += NT) {
      sa[i] = a[base + i];
      sd[i] = d[base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) {
        t = __fadd_rn(max_nan(t, sa[i]), sd[i]);
        sa[i] = t;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += NT) out[base + i] = sa[i];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) slack_pack_kernel(
    const int* __restrict__ seq, const uint8_t* __restrict__ act,
    const float* __restrict__ s_min_p, const float* __restrict__ table,
    const int* __restrict__ bsz_edges, const int* __restrict__ seq_edges,
    uint8_t* __restrict__ sel, int* __restrict__ count_out, int n, int nb, int ns) {
  __shared__ float lut[MAX_LUT];
  __shared__ int be[MAX_EDGES], se[MAX_EDGES];
  __shared__ int si[TILE];
  __shared__ uint8_t flag[TILE];  // active on the way in, selected on the way out
  for (int i = threadIdx.x; i < nb * ns; i += NT) lut[i] = table[i];
  for (int i = threadIdx.x; i < nb; i += NT) be[i] = bsz_edges[i];
  for (int i = threadIdx.x; i < ns; i += NT) se[i] = seq_edges[i];
  __syncthreads();
  const float s_min = *s_min_p;
  int count = 0, bi = bucket(be, nb, 1);  // bi: the bucket of a batch of count + 1
  float t_cur = 0.f;
  for (int base = 0; base < n; base += TILE) {
    const int m = min(TILE, n - base);
    for (int i = threadIdx.x; i < m; i += NT) {
      si[i] = bucket(se, ns, seq[base + i]);
      flag[i] = act[base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < m; ++i) {
        const float t_step = lut[bi * ns + si[i]];
        const bool improves =
            count == 0 || __fmul_rn((float)(count + 1), t_cur) > __fmul_rn((float)count, t_step);
        const bool cond = flag[i] && t_step <= s_min && improves;
        if (cond) {
          ++count;
          t_cur = t_step;
          bi = bucket(be, nb, count + 1);
        }
        flag[i] = cond;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += NT) sel[base + i] = flag[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) *count_out = count;
}

}  // namespace

extern "C" int repro_fcfs_scan(const void* a, const void* d, const void* t0, void* out, int n,
                               void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  fcfs_scan_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(d), static_cast<const float*>(t0),
      static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" int repro_slack_pack(const void* seq, const void* act, const void* s_min,
                                const void* table, const void* bsz_edges, const void* seq_edges,
                                void* sel, void* count, int n, int nb, int ns, void* stream) {
  if (n < 1 || nb < 1 || ns < 1 || nb > MAX_EDGES || ns > MAX_EDGES || nb * ns > MAX_LUT)
    return (int)cudaErrorInvalidValue;
  slack_pack_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seq), static_cast<const uint8_t*>(act),
      static_cast<const float*>(s_min), static_cast<const float*>(table),
      static_cast<const int*>(bsz_edges), static_cast<const int*>(seq_edges),
      static_cast<uint8_t*>(sel), static_cast<int*>(count), n, nb, ns);
  return (int)cudaGetLastError();
}
