// The whole projected-gradient solve of a batch of box QPs in one launch:
// clip the warm start into the box, then `iters` Jacobi steps
//
//     lam_t = clip(lam_{t-1} + gamma * (q - K lam_{t-1}), 0, hi),
//
// optionally folding zl = Z^T lam of the final iterate into the same launch.
//
// Replaces the TPU kernel repro/kernels/qp_step.py:qp_pg_multi_1d
// (_qp_multi_kernel and _qp_multi_fold_kernel), which runs the iterations
// as a sequential grid dimension on one TPU core.  On Hopper the blocks
// run in parallel and in no order, so every iteration needs a barrier
// across all the rows of a problem: each row of iterate t reads the whole
// iterate t-1.  Two shapes:
//
// - block path (N <= kBlockMaxN, the paper's regime of tens to hundreds of
//   samples): one CTA per problem, both iterate buffers in shared memory,
//   __syncthreads() between iterations.  K stays in L2 across iterations.
// - grid path (larger N, e.g. 20000 with an 80 KB iterate): one cooperative
//   launch sized by the occupancy calculator, rows walked with a grid
//   stride, the iterate double-buffered in global memory and
//   cg::this_grid().sync() between iterations.
//
// K is fp32 or bf16 (the mixed mode: the iterate is rounded to bf16 for
// the product, the sum and the update stay fp32).  What bounds it on an
// H100: its bytes.  Each iteration streams K once; a K larger than the
// 50 MB L2 is read from HBM every iteration, which bf16 halves.  The fold
// sums each zl entry in a fixed order (per block, then over blocks in
// block order), so it is deterministic.
#include <cooperative_groups.h>

#include "qp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro_qp;

constexpr int kBlockMaxN = 1024;

template <typename KT, bool FOLD>
__global__ void __launch_bounds__(kThreads)
qp_multi_block_kernel(const KT* __restrict__ K, const float* __restrict__ lam0,
                      const float* __restrict__ q,
                      const float* __restrict__ hi,
                      const float* __restrict__ gamma,
                      const float* __restrict__ Z, float* __restrict__ lam_out,
                      float* __restrict__ zl, int N, int D, int iters) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + N;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * N;
  const KT* Kb = K + base * N;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float g = gamma[b];

  for (int i = threadIdx.x; i < N; i += blockDim.x)
    cur[i] = fminf(fmaxf(lam0[base + i], 0.f), hi[base + i]);
  __syncthreads();

  for (int t = 0; t < iters; ++t) {
    for (int r0 = warp * kRows; r0 < N; r0 += kWarps * kRows) {
      float acc[kRows];
      row_group_matvec(Kb, cur, N, r0, acc);
      const float Klam = lane_sum(acc);
      const int r = r0 + lane;
      if (lane < kRows && r < N)
        nxt[r] = pg_update(cur[r], Klam, q[base + r], hi[base + r], g);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int i = threadIdx.x; i < N; i += blockDim.x) lam_out[base + i] = cur[i];
  if (FOLD) {
    const float* Zb = Z + base * D;
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float s = 0.f;
      for (int n = 0; n < N; ++n) s = fmaf(cur[n], Zb[(size_t)n * D + d], s);
      zl[(size_t)b * D + d] = s;
    }
  }
}

// buf: (2, B, N) iterate buffers; partial: (B, gridDim.x, D) fold scratch.
// Iterate buffers are written during the launch, so they are read through
// plain (coherent) loads: no __restrict__ on them.
template <typename KT, bool FOLD>
__global__ void __launch_bounds__(kThreads)
qp_multi_grid_kernel(const KT* __restrict__ K, const float* __restrict__ lam0,
                     const float* __restrict__ q, const float* __restrict__ hi,
                     const float* __restrict__ gamma,
                     const float* __restrict__ Z, float* lam_out, float* zl,
                     float* buf, float* partial, int B, int N, int D,
                     int iters) {
  cg::grid_group grid = cg::this_grid();
  const size_t total = (size_t)B * N;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float* cur = iters == 0 ? lam_out : buf;
  float* spare = buf + total;

  for (size_t i = tid; i < total; i += stride)
    cur[i] = fminf(fmaxf(lam0[i], 0.f), hi[i]);
  grid.sync();

  const int lane = threadIdx.x % 32;
  const long long groups_per_problem = (N + kRows - 1) / kRows;
  const long long groups = groups_per_problem * B;
  const long long warp0 = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * kWarps;
  for (int t = 0; t < iters; ++t) {
    float* dst = t == iters - 1 ? lam_out : spare;
    for (long long gidx = warp0; gidx < groups; gidx += warps) {
      const int b = (int)(gidx / groups_per_problem);
      const int r0 = (int)(gidx % groups_per_problem) * kRows;
      const size_t base = (size_t)b * N;
      float acc[kRows];
      row_group_matvec(K + base * N, cur + base, N, r0, acc);
      const float Klam = lane_sum(acc);
      const int r = r0 + lane;
      if (lane < kRows && r < N)
        dst[base + r] = pg_update(cur[base + r], Klam, q[base + r],
                                  hi[base + r], gamma[b]);
    }
    grid.sync();
    spare = cur;
    cur = dst;
  }

  if (FOLD) {
    const int nblk = gridDim.x;
    const int chunk = (N + nblk - 1) / nblk;
    const int n0 = blockIdx.x * chunk;
    const int n1 = min(N, n0 + chunk);
    for (int b = 0; b < B; ++b) {
      const size_t base = (size_t)b * N;
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float s = 0.f;
        for (int n = n0; n < n1; ++n)
          s = fmaf(cur[base + n], Z[(base + n) * D + d], s);
        partial[((size_t)b * nblk + blockIdx.x) * D + d] = s;
      }
    }
    grid.sync();
    for (size_t i = tid; i < (size_t)B * D; i += stride) {
      const size_t b = i / D;
      const size_t d = i % D;
      float s = 0.f;
      for (int k = 0; k < nblk; ++k) s += partial[(b * nblk + k) * D + d];
      zl[i] = s;
    }
  }
}

template <typename KT, bool FOLD>
cudaError_t grid_size(int* blocks) {
  int per_sm = 0, device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, qp_multi_grid_kernel<KT, FOLD>, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <typename KT, bool FOLD>
cudaError_t launch(const KT* K, const float* lam0, const float* q,
                   const float* hi, const float* gamma, const float* Z,
                   float* lam_out, float* zl, float* buf, float* partial,
                   int B, int N, int D, int iters, int grid_blocks,
                   cudaStream_t stream) {
  if (N <= kBlockMaxN) {
    const size_t smem = 2 * (size_t)N * sizeof(float);
    qp_multi_block_kernel<KT, FOLD><<<B, kThreads, smem, stream>>>(
        K, lam0, q, hi, gamma, Z, lam_out, zl, N, D, iters);
    return cudaGetLastError();
  }
  void* args[] = {(void*)&K,     (void*)&lam0, (void*)&q,       (void*)&hi,
                  (void*)&gamma, (void*)&Z,    (void*)&lam_out, (void*)&zl,
                  (void*)&buf,   (void*)&partial, (void*)&B,    (void*)&N,
                  (void*)&D,     (void*)&iters};
  return cudaLaunchCooperativeKernel((void*)qp_multi_grid_kernel<KT, FOLD>,
                                     dim3(grid_blocks), dim3(kThreads), args,
                                     0, stream);
}

}  // namespace

// Blocks of the cooperative grid the launch below uses for N, or 0 where
// the one-CTA-per-problem path runs (which needs no scratch).  The caller
// sizes `buf` (2*B*N) and `partial` (B*blocks*D) from it.
cudaError_t repro_qp_multi_grid(int k_bf16, int fold, int B, int N,
                                int* blocks) {
  if (N <= kBlockMaxN || B == 0) {
    *blocks = 0;
    return cudaSuccess;
  }
  cudaError_t err =
      k_bf16 ? (fold ? grid_size<__nv_bfloat16, true>(blocks)
                     : grid_size<__nv_bfloat16, false>(blocks))
             : (fold ? grid_size<float, true>(blocks)
                     : grid_size<float, false>(blocks));
  if (err != cudaSuccess) return err;
  // no more blocks than there are warps' worth of rows
  const long long groups = (long long)B * ((N + kRows - 1) / kRows);
  const long long needed = (groups + kWarps - 1) / kWarps;
  if (needed < *blocks) *blocks = (int)needed;
  if (*blocks < 1) return cudaErrorLaunchOutOfResources;
  return cudaSuccess;
}

// K (B, N, N) fp32 or bf16 (k_bf16); lam0, q, hi, lam_out (B, N); gamma
// (B,); Z (B, N, D) and zl (B, D) when fold; buf/partial as sized above.
cudaError_t repro_qp_multi_launch(int k_bf16, int fold, const void* K,
                                  const float* lam0, const float* q,
                                  const float* hi, const float* gamma,
                                  const float* Z, float* lam_out, float* zl,
                                  float* buf, float* partial, int B, int N,
                                  int D, int iters, int grid_blocks,
                                  cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (k_bf16) {
    const __nv_bfloat16* Kh = static_cast<const __nv_bfloat16*>(K);
    return fold ? launch<__nv_bfloat16, true>(Kh, lam0, q, hi, gamma, Z,
                                              lam_out, zl, buf, partial, B, N,
                                              D, iters, grid_blocks, stream)
                : launch<__nv_bfloat16, false>(Kh, lam0, q, hi, gamma, Z,
                                               lam_out, zl, buf, partial, B,
                                               N, D, iters, grid_blocks,
                                               stream);
  }
  const float* Kf = static_cast<const float*>(K);
  return fold ? launch<float, true>(Kf, lam0, q, hi, gamma, Z, lam_out, zl,
                                    buf, partial, B, N, D, iters, grid_blocks,
                                    stream)
              : launch<float, false>(Kf, lam0, q, hi, gamma, Z, lam_out, zl,
                                     buf, partial, B, N, D, iters,
                                     grid_blocks, stream);
}

cudaError_t repro_qp_multi_attributes(int which, cudaFuncAttributes* attr,
                                      const char** name) {
  switch (which) {
    case 0:
      *name = "qp_multi_block_kernel<f32>";
      return cudaFuncGetAttributes(attr, qp_multi_block_kernel<float, false>);
    case 1:
      *name = "qp_multi_block_kernel<f32,fold>";
      return cudaFuncGetAttributes(attr, qp_multi_block_kernel<float, true>);
    case 2:
      *name = "qp_multi_block_kernel<bf16>";
      return cudaFuncGetAttributes(
          attr, qp_multi_block_kernel<__nv_bfloat16, false>);
    case 3:
      *name = "qp_multi_block_kernel<bf16,fold>";
      return cudaFuncGetAttributes(
          attr, qp_multi_block_kernel<__nv_bfloat16, true>);
    case 4:
      *name = "qp_multi_grid_kernel<f32>";
      return cudaFuncGetAttributes(attr, qp_multi_grid_kernel<float, false>);
    case 5:
      *name = "qp_multi_grid_kernel<f32,fold>";
      return cudaFuncGetAttributes(attr, qp_multi_grid_kernel<float, true>);
    case 6:
      *name = "qp_multi_grid_kernel<bf16>";
      return cudaFuncGetAttributes(
          attr, qp_multi_grid_kernel<__nv_bfloat16, false>);
    case 7:
      *name = "qp_multi_grid_kernel<bf16,fold>";
      return cudaFuncGetAttributes(
          attr, qp_multi_grid_kernel<__nv_bfloat16, true>);
    default:
      return cudaErrorInvalidValue;
  }
}
