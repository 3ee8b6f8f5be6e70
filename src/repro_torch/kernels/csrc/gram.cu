// Weighted Gram blocks K = Z diag(a) Z^T for a batch of problems, fp32 on
// the CUDA cores.
//
// What each kernel replaces (the TPU kernels of src/repro/kernels/gram.py):
//
// - gram_kernel: weighted_gram_2d (:77, its pallas_call body _gram_kernel
//   :66), the square K[b] = Z[b] diag(a[b]) Z[b]^T that the reference maps
//   over the (V, T) batch with lax.map.
// - gram_tiled_kernel: weighted_gram_tiled (:121) as the streamed build
//   uses it, a row panel Z[b][s:s+M] diag(a[b]) Z[b]^T: rows [s, s + M)
//   of K written straight into a caller's output view (a base pointer, a
//   batch stride and a row stride), so one streamed panel of the large-n
//   build lands in its rows of a preallocated K.
// - gram_prescale_kernel: the `zia = zi * a` of _gram_kernel (:70), done
//   once per build: Z laid out feature-major, unscaled and scaled by a,
//   for the other two (where the TPU kernels pad Z to the (8, 128) VMEM
//   layout).  It has no pallas_call of its own.  It is bound by its bytes
//   (Z read once, written twice) and goes through a 32x33 shared tile so
//   both sides are coalesced.
//
// What bounds the Gram kernels on an H100: at D = 257 the fp32 FMAs (no
// tensor cores: the port's fp32 contract forbids TF32).  The large fit's
// square build (B = 2, N = 20000) needs B*N*(N+1)*D = 2.06e11 FLOPs, 3.07
// ms at 67 TFLOP/s, against 3.2 GB of K written, 0.96 ms at 3.35 TB/s.
// At the paper's D = 11 the B*N*N output write bounds it, and a launch
// takes longer than either.  What the design does about it:
//
// - The square kernel computes one triangle: one CTA per 128x128 tile
//   pair (ti <= tj) of each problem, T(T+1)/2 of them with T = ceil(N/128),
//   the batch in grid z.  Each tile is stored, and stored transposed into
//   its mirror position: half the FMAs of the full square.
// - A CTA is 256 threads, each with an 8x8 accumulator whose 8 rows and 8
//   columns are two 4-wide halves 64 apart, so each float4 shared load of
//   a warp is a broadcast (rows) or 256 contiguous bytes (columns): no bank
//   conflicts, 64 FMAs per 4 shared loads.
// - Operands are staged 16 features at a time through a 3-stage ring that
//   16-byte cp.async.cg copies fill from the prescaled feature-major
//   copies, so two stages load while one computes and no thread touches a
//   stage between its copy and the barrier.  Ragged N and D are
//   zero-filled by the copy's source size, not padded in device memory,
//   and a ragged last stage computes only its features (D = 257 is 16
//   full stages and one feature).
// - __launch_bounds__(256, 2): at most 128 registers, two CTAs (2 x 48 KB
//   of shared memory) per SM, no local memory (chip_smoke.py phase 2
//   prints registers, shared and local bytes).
//
// One rule fixes every element's arithmetic: K[i][j] is the sum over
// d = 0..D-1, in order, of fmaf(Z[lo][d] * a[d], Z[hi][d], .) with
// lo = min(i, j) and hi = max(i, j) (fmaf's product does not depend on the
// order of its factors).  Both kernels run one tile routine over the same
// 128-aligned tiles of K.  It scales the operand of the lower index (the
// rows of a tile above the diagonal, the columns of one below it) and
// stores a diagonal tile's upper half, then its mirror, transposed, into
// the lower half.  The square kernel runs the tiles with ti <= tj and
// mirrors each.  The tiled kernel runs the tiles its rows overlap, but
// where both tiles of a pair lie in its rows (the panel's own diagonal
// block, symmetric) it runs only ti <= tj and mirrors each, as the square
// kernel does: the block's lower half costs no FMAs (3888 CTAs instead of
// a plain grid's 4239 for a 3352-row panel of N = 20000, 6.9% less time
// on an H100; PERF.md section 6).  So K is bitwise symmetric, a panel is
// bitwise the square kernel's rows, and a streamed K is bitwise the dense
// K.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 128;     // output tile edge
constexpr int kHalf = kTile / 2;
constexpr int kDepth = 16;     // features per stage
constexpr int kStages = 3;     // stages of the cp.async ring
constexpr int kThreads = 256;  // 16 x 16 threads, 8x8 outputs each
constexpr int kMinBlocks = 2;  // CTAs per SM the registers are bounded for
constexpr int kVec = 4;        // floats per 16-byte copy
constexpr int kChunks = kDepth * kTile / kVec;  // copies per operand, stage
constexpr int kPrescaleTile = 32;

// the stage ring: [stage][operand A, B][feature][row of the tile]
struct __align__(16) Ring {
  float op[kStages][2][kDepth][kTile];
};

// which elements of a tile a store writes: all, or by the diagonal
enum Keep { kAll, kUpper, kLower };

// one operand tile: rows [first, first + kTile) of a feature-major
// (D, ld) block whose rows beyond `rows` are not there
struct Operand {
  const float* t;
  int ld;
  int rows;
  int first;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start this thread's copies of features [kt * kDepth, +kDepth) of both
// operands into stage s.  A copy past D or past an operand's rows reads
// nothing and zero-fills.
__device__ __forceinline__ void load_stage(Ring& ring, int s, int kt,
                                           const Operand& A,
                                           const Operand& B, int D) {
#pragma unroll
  for (int h = 0; h < kChunks / kThreads; ++h) {
    const int c = threadIdx.x + h * kThreads;
    const int k = c / (kTile / kVec);
    const int col = (c % (kTile / kVec)) * kVec;
    const int d = kt * kDepth + k;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const Operand& op = o == 0 ? A : B;
      const int row = op.first + col;
      const float* src = op.t;
      int bytes = 0;
      if (d < D && row < op.rows) {
        src = op.t + (size_t)d * op.ld + row;
        bytes = min(op.rows - row, kVec) * 4;
      }
      cp_async16(&ring.op[s][o][k][col], src, bytes);
    }
  }
}

// acc[m][n] = fmaf(A[row(m)][k], B[col(n)][k], acc[m][n]) for feature k
// of a stage, where this thread's row(m) = (m / 4) * 64 + ty * 4 + m % 4
// and col(n) = (n / 4) * 64 + tx * 4 + n % 4.
__device__ __forceinline__ void fma_feature(const float* As, const float* Bs,
                                            int k, float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float4 a0 = *reinterpret_cast<const float4*>(As + k * kTile + ty * 4);
  const float4 a1 =
      *reinterpret_cast<const float4*>(As + k * kTile + kHalf + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kTile + tx * 4);
  const float4 b1 =
      *reinterpret_cast<const float4*>(Bs + k * kTile + kHalf + tx * 4);
  const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(ar[m], br[n], acc[m][n]);
}

// acc[m][n] = sum_d fmaf(A[row(m)][d], B[col(n)][d], .), d in order.  The
// features of a ragged last stage past D are skipped, not multiplied by
// zero.
__device__ __forceinline__ void tile_product(Ring& ring, const Operand& A,
                                             const Operand& B, int D,
                                             float (&acc)[8][8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.f;

  const int kt_n = (D + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_n) load_stage(ring, s, s, A, B, D);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of stage s
    __syncthreads();  // stage s is whole; stage kt - 1 is read by no one
    const int next = kt + kStages - 1;
    if (next < kt_n) load_stage(ring, next % kStages, next, A, B, D);
    cp_async_commit();

    const float* As = &ring.op[s][0][0][0];
    const float* Bs = &ring.op[s][1][0][0];
    const int features = min(kDepth, D - kt * kDepth);
    if (features == kDepth) {
#pragma unroll
      for (int k = 0; k < kDepth; ++k) fma_feature(As, Bs, k, acc);
    } else {
#pragma unroll 1
      for (int k = 0; k < features; ++k) fma_feature(As, Bs, k, acc);
    }
  }
}

// Write 4 values to columns c..c+3 of row r of K, kept where `keep`
// admits them (kUpper r <= c, kLower r > c) and c < N; `out` holds rows
// [row_lo, ...) of K, ldo apart.  One 16-byte store where all four go and
// `vec` says the rows are 16-byte aligned.
__device__ __forceinline__ void store4(float* __restrict__ out, size_t ldo,
                                       int row_lo, int r, int c, int N,
                                       Keep keep, bool vec, float v0,
                                       float v1, float v2, float v3) {
  float* row = out + (size_t)(r - row_lo) * ldo;
  if (vec && keep == kAll && c + 3 < N) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v0, v1, v2, v3);
    return;
  }
  const float v[4] = {v0, v1, v2, v3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int cc = c + e;
    const bool kept = keep == kAll || (keep == kUpper ? r <= cc : r > cc);
    if (cc < N && kept) row[cc] = v[e];
  }
}

// acc[m][n] into K[r0 + row(m)][c0 + col(n)], or transposed into
// K[r0 + col(n)][c0 + row(m)], for the rows of K in [row_lo, row_hi).
template <bool kTransposed>
__device__ __forceinline__ void store_tile(const float (&acc)[8][8],
                                           float* __restrict__ out,
                                           size_t ldo, int row_lo,
                                           int row_hi, int N, int r0, int c0,
                                           Keep keep, bool vec) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int own_r = kTransposed ? tx : ty;  // the 4-runs down the rows
  const int own_c = kTransposed ? ty : tx;  // the 4-runs along a row
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = r0 + (u / 4) * kHalf + own_r * 4 + u % 4;
    if (r < row_lo || r >= row_hi) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + h * kHalf + own_c * 4;
      if (kTransposed) {
        store4(out, ldo, row_lo, r, c, N, keep, vec, acc[h * 4][u],
               acc[h * 4 + 1][u], acc[h * 4 + 2][u], acc[h * 4 + 3][u]);
      } else {
        store4(out, ldo, row_lo, r, c, N, keep, vec, acc[u][h * 4],
               acc[u][h * 4 + 1], acc[u][h * 4 + 2], acc[u][h * 4 + 3]);
      }
    }
  }
}

// Zs[0][b][d][n] = Z[b][n][d] and Zs[1][b][d][n] = Z[b][n][d] * a[b][d]:
// (2, B, D, ld), rows ld >= N apart; no kernel reads the pad columns.
__global__ void __launch_bounds__(kThreads)
gram_prescale_kernel(const float* __restrict__ Z, const float* __restrict__ a,
                     float* __restrict__ Zs, int B, int N, int ld, int D) {
  __shared__ float tile[kPrescaleTile][kPrescaleTile + 1];
  const int b = blockIdx.z;
  const int n0 = blockIdx.x * kPrescaleTile;
  const int d0 = blockIdx.y * kPrescaleTile;
  const float* zb = Z + (size_t)b * N * D;
  float* plain = Zs + (size_t)b * D * ld;
  float* scaled = plain + (size_t)B * D * ld;
  const int tx = threadIdx.x % kPrescaleTile;
  const int ty = threadIdx.x / kPrescaleTile;
  constexpr int kStep = kThreads / kPrescaleTile;
  for (int r = ty; r < kPrescaleTile; r += kStep) {
    const int n = n0 + r, d = d0 + tx;
    if (n < N && d < D) tile[r][tx] = zb[(size_t)n * D + d];
  }
  __syncthreads();
  for (int r = ty; r < kPrescaleTile; r += kStep) {
    const int d = d0 + r, n = n0 + tx;
    if (d < D && n < N) {
      const float v = tile[tx][r];
      plain[(size_t)d * ld + n] = v;
      scaled[(size_t)d * ld + n] = v * a[(size_t)b * D + d];
    }
  }
}

// Output tile (ti, tj) of problem b's K, for its rows in [row_lo, row_hi):
// `out` holds row row_lo of K, rows ldo apart.  The scaled operand is the
// one of the lower index: the rows above the diagonal, the columns below
// it.  A diagonal tile stores its upper half and, transposed, the mirror
// of it; with `mirror` an upper tile is also stored transposed into the
// lower triangle.
__device__ __forceinline__ void gram_tile(Ring& ring,
                                          const float* __restrict__ Zs,
                                          int B, int N, int ld, int D, int b,
                                          int ti, int tj,
                                          float* __restrict__ out, size_t ldo,
                                          int row_lo, int row_hi,
                                          bool mirror) {
  const float* plain = Zs + (size_t)b * D * ld;
  const float* scaled = plain + (size_t)B * D * ld;
  float acc[8][8];
  tile_product(ring, Operand{ti <= tj ? scaled : plain, ld, N, ti * kTile},
               Operand{ti <= tj ? plain : scaled, ld, N, tj * kTile}, D, acc);
  const bool vec = (reinterpret_cast<uintptr_t>(out) % 16) == 0 &&
                   ldo % kVec == 0;
  const bool diagonal = ti == tj;
  store_tile<false>(acc, out, ldo, row_lo, row_hi, N, ti * kTile, tj * kTile,
                    diagonal ? kUpper : kAll, vec);
  if (diagonal || (mirror && ti < tj)) {
    store_tile<true>(acc, out, ldo, row_lo, row_hi, N, tj * kTile,
                     ti * kTile, diagonal ? kLower : kAll, vec);
  }
}

// Tile pair p of the upper triangle, column by column: (0,0), (0,1),
// (1,1), (0,2), ...; ti <= tj.
__device__ __forceinline__ void tile_pair(long long p, int& ti, int& tj) {
  long long j = static_cast<long long>((sqrt(8.0 * p + 1.0) - 1.0) * 0.5);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  tj = static_cast<int>(j);
  ti = static_cast<int>(p - j * (j + 1) / 2);
}

// Zs: gram_prescale_kernel's (2, B, D, ld) of Z (B, N, D); K (B, N, N).
// One CTA per tile pair ti <= tj, the lower triangle stored as the mirror.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gram_kernel(const float* __restrict__ Zs, float* __restrict__ K, int B,
            int N, int ld, int D) {
  __shared__ Ring ring;
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  gram_tile(ring, Zs, B, N, ld, D, blockIdx.z, ti, tj,
            K + (size_t)blockIdx.z * N * N, (size_t)N, 0, N, true);
}

// Rows [row0, row0 + M) of K into out (element (b, r, j) at
// out[b * out_batch_stride + r * ldo + j]).  The rows overlap R tile rows
// t0..t0+R-1 of the square kernel's 128-row tiles; the CTAs take, in
// order, the tiles left of the panel's diagonal block (tj < t0), the
// block's tile pairs ti <= tj (each mirrored into the block's lower
// half, as in the square kernel), and the tiles right of it
// (tj >= t0 + R).  So each element comes out of the same operands in the
// same order as in the square kernel.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gram_tiled_kernel(const float* __restrict__ Zs, float* __restrict__ out,
                  size_t out_batch_stride, size_t ldo, int B, int N, int ld,
                  int D, int row0, int M) {
  __shared__ Ring ring;
  const int t0 = row0 / kTile;
  const int R = (row0 + M - 1) / kTile - t0 + 1;
  const long long left = static_cast<long long>(R) * t0;
  const long long block = static_cast<long long>(R) * (R + 1) / 2;
  long long p = blockIdx.x;
  int ti, tj;
  bool mirror = false;
  if (p < left) {
    ti = t0 + static_cast<int>(p / t0);
    tj = static_cast<int>(p % t0);
  } else if (p - left < block) {
    tile_pair(p - left, ti, tj);
    ti += t0;
    tj += t0;
    mirror = true;
  } else {
    p -= left + block;
    const int right = (N + kTile - 1) / kTile - t0 - R;
    ti = t0 + static_cast<int>(p / right);
    tj = t0 + R + static_cast<int>(p % right);
  }
  gram_tile(ring, Zs, B, N, ld, D, blockIdx.z, ti, tj,
            out + (size_t)blockIdx.z * out_batch_stride, ldo, row0,
            row0 + M, mirror);
}

}  // namespace

// The feature-major row stride for N rows: N rounded up to 16 bytes.
int repro_gram_ld(int n) { return (n + kVec - 1) / kVec * kVec; }

// The most rows a square build or a panel takes (the grid's tile count).
int repro_gram_max_rows() { return 65535 * kTile; }

// Z (B, N, D), a (B, D) contiguous -> Zs (2, B, D, repro_gram_ld(N)).
cudaError_t repro_gram_prescale_launch(const float* Z, const float* a,
                                       float* Zs, int B, int N, int D,
                                       cudaStream_t stream) {
  if (B == 0 || N == 0 || D == 0) return cudaSuccess;
  const dim3 grid((N + kPrescaleTile - 1) / kPrescaleTile,
                  (D + kPrescaleTile - 1) / kPrescaleTile, B);
  gram_prescale_kernel<<<grid, kThreads, 0, stream>>>(Z, a, Zs, B, N,
                                                      repro_gram_ld(N), D);
  return cudaGetLastError();
}

// Zs (2, B, D, repro_gram_ld(N)) of Z (B, N, D) -> K (B, N, N) contiguous.
cudaError_t repro_gram_launch(const float* Zs, float* K, int B, int N, int D,
                              cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  const long long tiles = (N + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles * (tiles + 1) / 2), 1, B);
  gram_kernel<<<grid, kThreads, 0, stream>>>(Zs, K, B, N, repro_gram_ld(N),
                                             D);
  return cudaGetLastError();
}

// Zs as for repro_gram_launch -> rows [row0, row0 + M) of K into out:
// element (b, r, j) at out[b * out_batch_stride + r * ldo + j].
cudaError_t repro_gram_tiled_launch(const float* Zs, float* out,
                                    size_t out_batch_stride, size_t ldo,
                                    int B, int N, int D, int row0, int M,
                                    cudaStream_t stream) {
  if (B == 0 || M == 0 || N == 0) return cudaSuccess;
  const long long tiles = (N + kTile - 1) / kTile;
  const long long R = (row0 + M - 1) / kTile - row0 / kTile + 1;
  const long long blocks = R * (tiles - R) + R * (R + 1) / 2;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), 1, B);
  gram_tiled_kernel<<<grid, kThreads, 0, stream>>>(
      Zs, out, out_batch_stride, ldo, B, N, repro_gram_ld(N), D, row0, M);
  return cudaGetLastError();
}

cudaError_t repro_gram_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name) {
  switch (which) {
    case 0:
      *name = "gram_kernel";
      return cudaFuncGetAttributes(attr, gram_kernel);
    case 1:
      *name = "gram_tiled_kernel";
      return cudaFuncGetAttributes(attr, gram_tiled_kernel);
    case 2:
      *name = "gram_prescale_kernel";
      return cudaFuncGetAttributes(attr, gram_prescale_kernel);
    default:
      return cudaErrorInvalidValue;
  }
}
