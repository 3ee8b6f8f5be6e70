// One fused projected-gradient step of a batch of box QPs:
//
//     lam[b] <- clip(lam[b] + gamma[b] * (q[b] - K[b] lam[b]), 0, hi[b])
//
// Replaces the TPU kernel repro/kernels/qp_step.py:qp_pg_step_1d
// (_qp_step_kernel), which the reference maps over the (V, T) batch with
// lax.map and pads to 128 lanes.  Here the batch is the launch grid's y
// dimension, gamma is one step per problem, and the edges are masked.
//
// What bounds it on an H100: its bytes.  Each step reads K once (B*N*N
// floats) for 2 flops per element.  The design reads every K row once,
// coalesced, one warp per four rows (qp_common.cuh), and fuses the
// gradient step and the box projection into the warp that finishes the
// row's dot product, so nothing but the new iterate goes back to memory.
#include "qp_common.cuh"

namespace {

using namespace repro_qp;

__global__ void __launch_bounds__(kThreads)
qp_step_kernel(const float* __restrict__ K, const float* __restrict__ lam,
               const float* __restrict__ q, const float* __restrict__ hi,
               const float* __restrict__ gamma, float* __restrict__ out,
               int N) {
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * kWarps + warp) * kRows;
  if (r0 >= N) return;
  const size_t base = (size_t)b * N;
  float acc[kRows];
  row_group_matvec(K + base * N, lam + base, N, r0, acc);
  const float Klam = lane_sum(acc);
  const int r = r0 + lane;
  if (lane < kRows && r < N)
    out[base + r] = pg_update(lam[base + r], Klam, q[base + r], hi[base + r],
                              gamma[b]);
}

}  // namespace

// K (B, N, N); lam, q, hi, out (B, N); gamma (B,): fp32, contiguous.
cudaError_t repro_qp_step_launch(const float* K, const float* lam,
                                 const float* q, const float* hi,
                                 const float* gamma, float* out, int B, int N,
                                 cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const int per_block = kWarps * kRows;
  const dim3 grid((N + per_block - 1) / per_block, B);
  qp_step_kernel<<<grid, kThreads, 0, stream>>>(K, lam, q, hi, gamma, out, N);
  return cudaGetLastError();
}

cudaError_t repro_qp_step_attributes(int which, cudaFuncAttributes* attr,
                                     const char** name) {
  if (which != 0) return cudaErrorInvalidValue;
  *name = "qp_step_kernel";
  return cudaFuncGetAttributes(attr, qp_step_kernel);
}
