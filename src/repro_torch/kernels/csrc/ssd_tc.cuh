// What the SSD scan's tensor-core kernels share (ssd_scan.cu's forward,
// ssd_scan_bwd.cu's backward): the in-chunk cumsum of dt A, in base 2 so
// that every exp of it is one fast_exp2 (sm90.cuh).
#pragma once

namespace ssd_tc {

constexpr float LOG2E = 1.4426950408889634f;

// Inclusive cumsum of a * dt[0 .. Q) by one warp, in base 2: writes
// out[t] = log2(e) * sum_{k <= t} a dt_k and returns out[Q - 1] to every
// lane. Lane l owns rows l * Q/32 .. (l + 1) * Q/32 - 1.
template <int Q>
__device__ __forceinline__ float warp_cumsum_log2(const float* dt, float a, float* out, int lane) {
  constexpr int PER = Q / 32;
  float part[PER], run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += dt[lane * PER + k] * a;
    part[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) out[lane * PER + k] = (excl + part[k]) * LOG2E;
  return __shfl_sync(0xffffffffu, incl, 31) * LOG2E;
}

}  // namespace ssd_tc
