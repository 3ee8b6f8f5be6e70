// Shared pieces of the projected-gradient kernels (qp_step.cu, qp_multi.cu).
//
// One warp owns kRows consecutive rows of one problem's K: its 32 lanes
// stride over the columns, so each K row is read once, coalesced, and
// each iterate value a lane loads serves kRows rows.  Rows past the edge
// re-read the last row and are never written.  The step kernel's
// row_group_matvec reads K and the iterate a value a lane; qp_multi.cu
// shares the row groups, the warp and lane sums and the update.
#pragma once

#include <cuda_runtime.h>

namespace repro_qp {

constexpr int kRows = 4;     // rows per warp
constexpr int kWarps = 8;    // warps per block
constexpr int kThreads = kWarps * 32;

// acc[k] summed across the warp, so every lane holds the row's total.
__device__ __forceinline__ void warp_sum(float (&acc)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], off);
}

// acc[k] = sum_c K[r0 + k, c] * lam[c] for k < kRows, on every lane.
__device__ __forceinline__ void row_group_matvec(const float* __restrict__ Kb,
                                                 const float* lam, int N,
                                                 int r0, float (&acc)[kRows]) {
  const int lane = threadIdx.x % 32;
  const float* rows[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    acc[k] = 0.f;
    rows[k] = Kb + (size_t)min(r0 + k, N - 1) * N;
  }
  for (int c = lane; c < N; c += 32) {
    const float l = lam[c];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = fmaf(rows[k][c], l, acc[k]);
  }
  warp_sum(acc);
}

// The row this lane writes (lane k < kRows owns row r0 + k) and its Klam.
__device__ __forceinline__ float lane_sum(const float acc[kRows]) {
  const int lane = threadIdx.x % 32;
  float s = acc[0];
#pragma unroll
  for (int k = 1; k < kRows; ++k)
    if (lane == k) s = acc[k];
  return s;
}

// clip(lam + gamma * (q - Klam), 0, hi)
__device__ __forceinline__ float pg_update(float lam, float Klam, float q,
                                           float hi, float gamma) {
  const float stepped = lam + gamma * (q - Klam);
  return fminf(fmaxf(stepped, 0.f), hi);
}

}  // namespace repro_qp
