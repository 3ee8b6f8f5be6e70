// The serving product of a fitted network: the decision values of a batch
// of rows against every hyperplane,
//
//     G[i, k] = bf[k] + sum_j X[i, j] * Wf[k, j]
//
// Not a TPU kernel: the reference leaves X @ Wf.T + bf to XLA
// (repro/serve/model.py:gemm_rows).  Its serving contract needs a row's
// values to be bitwise the same in every padded bucket and with any rows
// batched beside it, so the order of the sum must not depend on the
// batch.  A library GEMM does not promise that: it may choose another
// algorithm, and another split of the sum, for another number of rows.
//
// The order of the sum is a function of p alone.  A group of g lanes
// computes one row, g = min(32, the power of two at or above ceil(p/4)):
// 32 for wide rows, 4 at p = 10, so that 8 rows share a warp there.  The
// features fall into chunks of four (chunk c: features 4c .. 4c+3, the
// last one cut at p); lane l owns chunks l, l + g, l + 2g, ... and sums
// their features in ascending order with fmaf, from 0.  The g partial
// sums meet in a fixed xor butterfly (__shfl_xor_sync at g/2, g/4, ...,
// 1), and bf[k] is added last.  Nothing of it depends on M, on the row's
// index or its neighbours, on K, on the grid or on where X starts: a
// float4 load brings a chunk only where every row starts on 16 bytes
// (p % 4 == 0, X and Wf aligned), and otherwise four scalar loads bring
// the same values to the same fmafs.  No TF32, no atomics, no sum split
// across CTAs.
//
// What bounds it on an H100: not the card's rates.  Its bytes, 4 (M p +
// K p + K + M K), are 3.4 MB at most at the served and MNIST shapes (1 us
// at 3.35 TB/s), its work 2 M K p flops, 32 MFLOP at (1024, 20, 784)
// (0.5 us of fp32 FMA); at the large fit's model (1024, 2, 256) the bound
// is 0.3 us, under one launch.  What is left is latency: the chain of
// dependent steps one warp takes.  The design keeps that chain short:
// - a lane loads the chunks of its row that it owns up front into
//   registers (1, 2 or kHeld of them, as its share needs: all of the row
//   up to p = 4 * 32 * kHeld = 1024; past that, the rest is reloaded a
//   pass), all
//   independent, neighbouring lanes on neighbouring 16 bytes: one round
//   trip of coalesced loads, not p dependent ones;
// - the hyperplanes are taken kKTile at a time (a pass): the pass's
//   hyperplane chunks and biases are all loaded before its fmafs, through
//   the L1, which the CTA's rows share, and the kKTile chains and
//   butterflies interleave;
// - the grid: along x, one CTA where the rows' lanes fit kThreads, else
//   CTAs halved from kThreads lanes until there are kSms (an H100's SMs)
//   of them or they are one warp (M = 8 is one CTA; M = 1024 at
//   p = 256 or 784 is 256 CTAs of 128 lanes, at p = 10 128 CTAs of one
//   warp); along y, the passes dealt out to as many CTAs as keep the grid
//   within one wave of kSms * kSmWarps warps (the kSmWarps warps an
//   SM holds at the kernel's registers), so a small batch's
//   warps run one pass each and not all K in turn.  The K loop stays in
//   the kernel; a row's x is loaded once a slice.
//
// Why not tensor cores or TMA: the fp32 contract forbids TF32, and fp32
// has no tensor-core path.  Each byte is read once, in one wave, so an
// asynchronous copy (TMA, or cp.async into shared memory) has no later
// round trip to hide: a version that staged the hyperplanes in shared
// memory with cp.async was no faster on the card at the served and MNIST
// shapes than reading them through the L1, and it needs a barrier and,
// past 48 KB, the opt-in.  What is left at 1024 rows of 784 features is
// the L1's bandwidth (each row's group reads all of Wf) and each warp's
// chain of K / kKTile passes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSms = 132;
constexpr int kSmWarps = 8;
constexpr int kKTile = 4;
constexpr int kHeld = 8;

// lanes a row, as a power of two: min(32, pow2 >= ceil(p / 4))
int lanes_log2(int p) {
  const int chunks = (p + 3) / 4;
  int lg = 0;
  while ((1 << lg) < chunks && (1 << lg) < 32) ++lg;
  return lg;
}

// threads a CTA for M rows of 2^lg lanes
int block_threads(int M, int lg) {
  const long long lanes = (long long)M << lg;
  if (lanes <= kThreads) return (int)((lanes + 31) / 32 * 32);
  int threads = kThreads;
  while (threads > 32 && (lanes + threads - 1) / threads < kSms)
    threads /= 2;
  return threads;
}

// CTAs along y, each taking every slices-th pass of kKTile hyperplanes:
// as many as keep the grid within one wave of kSms * kSmWarps warps, at
// most one a pass
int pass_slices(int K, long long warps) {
  const long long wave = kSms * kSmWarps;
  const long long passes = (K + kKTile - 1) / kKTile;
  const long long fill = warps < wave ? wave / warps : 1;
  return (int)(passes < fill ? passes : fill);
}

// chunk c of a row: features 4c .. 4c+3, those at or past p read as 0;
// one 16-byte load where kVec (every row starts on 16 bytes, p % 4 == 0)
template <bool kVec>
__device__ __forceinline__ float4 load_chunk(const float* row, int c,
                                             int p) {
  if (kVec) return reinterpret_cast<const float4*>(row)[c];
  const int j = 4 * c;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = row[j];
  if (j + 1 < p) v.y = row[j + 1];
  if (j + 2 < p) v.z = row[j + 2];
  if (j + 3 < p) v.w = row[j + 3];
  return v;
}

// the features of chunk c (j = 4c) below p into acc, in ascending order
// (under kVec, p % 4 == 0: every chunk is whole)
template <bool kVec>
__device__ __forceinline__ float fma_chunk(float4 x, float4 w, int j, int p,
                                           float acc) {
  acc = fmaf(x.x, w.x, acc);
  if (kVec || j + 1 < p) acc = fmaf(x.y, w.y, acc);
  if (kVec || j + 2 < p) acc = fmaf(x.z, w.z, acc);
  if (kVec || j + 3 < p) acc = fmaf(x.w, w.w, acc);
  return acc;
}

// A lane group's work, each lane holding up to kHold chunks of its row.
// The loads of each stage are issued together, ahead of the fmafs that
// use them: the row's held chunks once, then each pass's hyperplane
// chunks and biases.  kVec and kHold pick only how a chunk is loaded and
// where it is kept, never which chunks a lane owns or their order.
template <bool kVec, int kHold>
__device__ __forceinline__ void rows_group(const float* __restrict__ W,
                                           const float* __restrict__ b,
                                           const float* __restrict__ X,
                                           float* __restrict__ out, int M,
                                           int K, int p, int lg) {
  const int g = 1 << lg;
  const int lane = threadIdx.x & (g - 1);
  const long long i =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> lg;
  const bool live = i < M;
  const int chunks = (p + 3) / 4;
  const float* x = X + (size_t)(live ? i : 0) * p;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 held[kHold];
#pragma unroll
  for (int s = 0; s < kHold; ++s) {
    const int c = lane + s * g;
    held[s] = live && c < chunks ? load_chunk<kVec>(x, c, p) : zero;
  }

  // a pass's hyperplane chunks and biases; what a pass does not load
  // (chunks past the row, hyperplanes past K) keeps the last pass's
  // values and reaches no stored sum
  float4 w[kKTile][kHold];
  float bias[kKTile];
#pragma unroll
  for (int u = 0; u < kKTile; ++u) {
    bias[u] = 0.f;
#pragma unroll
    for (int s = 0; s < kHold; ++s) w[u][s] = zero;
  }
  for (int k0 = blockIdx.y * kKTile; k0 < K; k0 += gridDim.y * kKTile) {
#pragma unroll
    for (int u = 0; u < kKTile; ++u) {
      if (k0 + u < K) {
        const float* wk = W + (size_t)(k0 + u) * p;
        bias[u] = b[k0 + u];
#pragma unroll
        for (int s = 0; s < kHold; ++s) {
          const int c = lane + s * g;
          if (c < chunks) w[u][s] = load_chunk<kVec>(wk, c, p);
        }
      }
    }
    float acc[kKTile];
#pragma unroll
    for (int u = 0; u < kKTile; ++u) {
      acc[u] = 0.f;
#pragma unroll
      for (int s = 0; s < kHold; ++s) {
        const int c = lane + s * g;
        if (c < chunks)
          acc[u] = fma_chunk<kVec>(held[s], w[u][s], 4 * c, p, acc[u]);
      }
    }
    // chunks past the held ones (p > 4 * 32 * kHold), in the same order
    for (int c = lane + kHold * g; c < chunks; c += g) {
      const float4 xc = live ? load_chunk<kVec>(x, c, p) : zero;
#pragma unroll
      for (int u = 0; u < kKTile; ++u)
        if (k0 + u < K)
          acc[u] = fma_chunk<kVec>(
              xc, load_chunk<kVec>(W + (size_t)(k0 + u) * p, c, p), 4 * c, p,
              acc[u]);
    }
    // the group's partial sums: the xor butterfly at g/2, g/4, ..., 1
    // (every lane of the warp takes part; a + b == b + a, so the lanes of
    // a group end with the same bits)
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      if (o < g) {
#pragma unroll
        for (int u = 0; u < kKTile; ++u)
          acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
      }
    }
    if (live) {
#pragma unroll
      for (int u = 0; u < kKTile; ++u)
        if (k0 + u < K && lane == (u & (g - 1)))
          out[(size_t)i * K + k0 + u] = acc[u] + bias[u];
    }
  }
}

// One instance a load width.  Each lane holds as many chunks as its share
// of the row needs, 1, 2 or kHeld (a branch on p alone, the same for the
// whole grid): a narrow row's lanes then carry neither the loads nor the
// predicates of a wide row's (at p = 10 holding kHeld took half again
// the device time on an H100).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rows_group_kernel(const float* __restrict__ W, const float* __restrict__ b,
                  const float* __restrict__ X, float* __restrict__ out,
                  int M, int K, int p, int lg) {
  const int share = ((p + 3) / 4 + (1 << lg) - 1) >> lg;
  if (share <= 1)
    rows_group<kVec, 1>(W, b, X, out, M, K, p, lg);
  else if (share <= 2)
    rows_group<kVec, 2>(W, b, X, out, M, K, p, lg);
  else
    rows_group<kVec, kHeld>(W, b, X, out, M, K, p, lg);
}

template <bool kVec>
cudaError_t launch(dim3 grid, int threads, cudaStream_t stream,
                   const float* W, const float* b, const float* X, float* out,
                   int M, int K, int p, int lg) {
  rows_group_kernel<kVec><<<grid, threads, 0, stream>>>(W, b, X, out, M, K,
                                                        p, lg);
  return cudaGetLastError();
}

// every instance, as kernel_info names it
struct Instance {
  const char* name;
  const void* fn;
};
const Instance kInstances[] = {
    {"rows_group_kernel<vec>", (const void*)rows_group_kernel<true>},
    {"rows_group_kernel<scalar>", (const void*)rows_group_kernel<false>},
};

}  // namespace

// W (K, p), b (K,), X (M, p) -> out (M, K): fp32, contiguous.
cudaError_t repro_rows_launch(const float* W, const float* b, const float* X,
                              float* out, int M, int K, int p,
                              cudaStream_t stream) {
  if (M == 0 || K == 0) return cudaSuccess;
  const int lg = lanes_log2(p);
  const int threads = block_threads(M, lg);
  const long long blocks = (((long long)M << lg) + threads - 1) / threads;
  const int slices = pass_slices(K, blocks * (threads / 32));
  const bool vec = p % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(X) |
                    reinterpret_cast<uintptr_t>(W)) % 16 == 0;
  const dim3 grid((unsigned)blocks, slices);
  return vec ? launch<true>(grid, threads, stream, W, b, X, out, M, K, p, lg)
             : launch<false>(grid, threads, stream, W, b, X, out, M, K, p, lg);
}

cudaError_t repro_rows_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name) {
  if (which < 0 || which >= (int)(sizeof(kInstances) / sizeof(Instance)))
    return cudaErrorInvalidValue;
  *name = kInstances[which].name;
  return cudaFuncGetAttributes(attr, kInstances[which].fn);
}
