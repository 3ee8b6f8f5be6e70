// Weighted Gram blocks K = Zm diag(a) Zn^T for a batch of problems.
//
// Two launchers over one tile body:
//
// - gram_kernel replaces the TPU kernel repro/kernels/gram.py:
//   weighted_gram_2d (_gram_kernel): the square K[b] = Z[b] diag(a[b])
//   Z[b]^T, which the reference maps over the (V, T) batch with lax.map.
// - gram_tiled_kernel replaces repro/kernels/gram.py:weighted_gram_tiled
//   (the same _gram_kernel body on a rectangular (tile_m, tile_n) grid): a
//   row panel Zm[b] diag(a[b]) Zn[b]^T written straight into a caller's
//   output view (a base pointer, a batch stride and a row stride), so one
//   streamed panel of the large-n build lands in its rows of a
//   preallocated K with no temporary.  The TPU's (tile_m, tile_n) is a
//   VMEM layout choice; here the CTA tile is the same 64x64 as the square
//   kernel's.
//
// Both launchers run gram_tile, so every element of K reduces over
// d = 0..D-1 in the same fmaf order whichever of them wrote it: a streamed
// K is bitwise the square kernel's K.
//
// What bounds it on an H100: at the paper's D = p+1 = 11 the output write
// (B*M*N floats) outweighs the 2*B*M*N*D FMA work, so it is bound by its
// bytes; at D = 257 it is bound by fp32 FMA throughput (no tensor cores:
// the port's fp32 contract forbids TF32).  The design: one CTA per 64x64
// output tile, Z panels staged through shared memory 16 features at a
// time with the `a` scaling fused into the load, a 4x4 register tile per
// thread fed by two 16-byte shared loads per feature, IEEE fp32 FMA, and
// masked edges instead of padding.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kDepth = 16;    // features staged per pass
constexpr int kThreads = 256; // 16 x 16 threads, 4x4 outputs each
// CTAs per SM the tiled launcher is compiled for.  Unbounded, its general
// addressing (two row bases, a strided output) takes more registers than
// the square kernel and fits fewer CTAs per SM; bounded to the square
// kernel's occupancy it spills nothing (chip_smoke.py phase 2 prints both
// kernels' registers and local memory).
constexpr int kTiledMinBlocks = 5;

// out[i, j] = sum_d Zm[i, d] a[d] Zn[j, d] for the 64x64 tile at (i0, j0)
// of an M x N block; row i of the output starts at out + i * ldo.
__device__ __forceinline__ void gram_tile(const float* __restrict__ Zm,
                                          const float* __restrict__ Zn,
                                          const float* __restrict__ a,
                                          float* __restrict__ out, size_t ldo,
                                          int M, int N, int D, int i0,
                                          int j0) {
  __shared__ __align__(16) float As[kDepth][kTile];  // Zm[i0+r, d] * a[d]
  __shared__ __align__(16) float Bs[kDepth][kTile];  // Zn[j0+r, d]

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
        if (i0 + r < M) za = Zm[(size_t)(i0 + r) * D + d] * a[d];
        if (j0 + r < N) zb = Zn[(size_t)(j0 + r) * D + d];
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

  // 16-byte stores where every row start is 16-byte aligned
  const int j = j0 + tx * 4;
  const bool vec = (ldo % 4) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0 && j + 3 < N;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + ty * 4 + m;
    if (i >= M) continue;
    float* row = out + (size_t)i * ldo;
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

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ Z, const float* __restrict__ a,
            float* __restrict__ K, int N, int D) {
  const int b = blockIdx.z;
  const float* Zb = Z + (size_t)b * N * D;
  gram_tile(Zb, Zb, a + (size_t)b * D, K + (size_t)b * N * N, (size_t)N, N,
            N, D, blockIdx.y * kTile, blockIdx.x * kTile);
}

__global__ void __launch_bounds__(kThreads, kTiledMinBlocks)
gram_tiled_kernel(const float* __restrict__ Zm, const float* __restrict__ a,
                  const float* __restrict__ Zn, float* __restrict__ out,
                  size_t out_batch_stride, size_t ldo, int M, int N, int D) {
  const int b = blockIdx.z;
  gram_tile(Zm + (size_t)b * M * D, Zn + (size_t)b * N * D,
            a + (size_t)b * D, out + (size_t)b * out_batch_stride, ldo, M, N,
            D, blockIdx.y * kTile, blockIdx.x * kTile);
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

// Zm (B, M, D), a (B, D), Zn (B, N, D): fp32, contiguous.  out: element
// (b, i, j) at out[b * out_batch_stride + i * ldo + j].
cudaError_t repro_gram_tiled_launch(const float* Zm, const float* a,
                                    const float* Zn, float* out,
                                    size_t out_batch_stride, size_t ldo,
                                    int B, int M, int N, int D,
                                    cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, B);
  gram_tiled_kernel<<<grid, kThreads, 0, stream>>>(
      Zm, a, Zn, out, out_batch_stride, ldo, M, N, D);
  return cudaGetLastError();
}

// The most rows M a tiled launch takes (grid y holds the row tiles).
int repro_gram_tiled_max_rows() { return 65535 * kTile; }

cudaError_t repro_gram_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name) {
  switch (which) {
    case 0:
      *name = "gram_kernel";
      return cudaFuncGetAttributes(attr, gram_kernel);
    case 1:
      *name = "gram_tiled_kernel";
      return cudaFuncGetAttributes(attr, gram_tiled_kernel);
    default:
      return cudaErrorInvalidValue;
  }
}
