// Weighted Gram build K[b] = Z[b] diag(a[b]) Z[b]^T for a batch of problems.
//
// Replaces the TPU kernel repro/kernels/gram.py:weighted_gram_2d
// (_gram_kernel), which the reference maps over the (V, T) batch with
// lax.map.  Here the batch is the launch grid's z dimension.
//
// What bounds it on an H100: at the paper's D = p+1 = 11 the output write
// (B*N*N floats) outweighs the 2*B*N*N*D FMA work, so it is bound by its
// bytes; at D = 257 it is bound by fp32 FMA throughput (no tensor cores:
// the port's fp32 contract forbids TF32).  The design: one CTA per 64x64
// output tile, Z panels staged through shared memory 16 features at a
// time with the `a` scaling fused into the load, a 4x4 register tile per
// thread fed by two 16-byte shared loads per feature, IEEE fp32 FMA, and
// masked edges instead of padding.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kDepth = 16;    // features staged per pass
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ Z, const float* __restrict__ a,
            float* __restrict__ K, int N, int D) {
  __shared__ __align__(16) float As[kDepth][kTile];  // Z[i0+r, d] * a[d]
  __shared__ __align__(16) float Bs[kDepth][kTile];  // Z[j0+r, d]

  const int b = blockIdx.z;
  const float* Zb = Z + (size_t)b * N * D;
  const float* ab = a + (size_t)b * D;
  float* Kb = K + (size_t)b * N * N;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kThreads) {
      const int r = e % kTile;
      const int k = e / kTile;
      const int d = k0 + k;
      float za = 0.f, zb = 0.f;
      if (d < D) {
        if (i0 + r < N) za = Zb[(size_t)(i0 + r) * D + d] * ab[d];
        if (j0 + r < N) zb = Zb[(size_t)(j0 + r) * D + d];
      }
      As[k][r] = za;
      Bs[k][r] = zb;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(ar[m], br[n], acc[m][n]);
    }
    __syncthreads();
  }

  const int j = j0 + tx * 4;
  const bool vec = (N % 4) == 0 && j + 3 < N;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty * 4 + m;
    if (i >= N) continue;
    float* row = Kb + (size_t)i * N;
    if (vec) {
      *reinterpret_cast<float4*>(row + j) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (j + n < N) row[j + n] = acc[m][n];
    }
  }
}

}  // namespace

// Z (B, N, D), a (B, D), K (B, N, N): fp32, contiguous, on the device.
cudaError_t repro_gram_launch(const float* Z, const float* a, float* K, int B,
                              int N, int D, cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const int tiles = (N + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  gram_kernel<<<grid, kThreads, 0, stream>>>(Z, a, K, N, D);
  return cudaGetLastError();
}

cudaError_t repro_gram_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name) {
  if (which != 0) return cudaErrorInvalidValue;
  *name = "gram_kernel";
  return cudaFuncGetAttributes(attr, gram_kernel);
}
