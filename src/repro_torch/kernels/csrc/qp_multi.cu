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
// iterate t-1.
//
// K is fp32 or bf16 (the mixed mode: the iterate is rounded to bf16 for
// the product, the sums, the step and the projection stay fp32).  What
// bounds it on an H100: its bytes.  Each iteration streams K once; a K
// larger than the 50 MB L2 is read from HBM every iteration, which bf16
// halves.  What the design does about it:
//
// - grid path (every N whose K does not fit in a CTA's shared memory, e.g.
//   the large fit's 2 x 20000): persistent cooperative CTAs, two per SM,
//   each owning a fixed contiguous range of the batch's row groups taken
//   in problem order, all ranges the same size to a group: with fewer
//   problems than CTAs a range lies in one problem, with more it may span
//   two or three.  Every iteration a CTA copies each of its problems'
//   iterates into
//   shared memory once, already in the product's type (bf16 mode: 40 KB
//   at N = 20000), in column chunks where it exceeds kStageBytes; its
//   warps then read the iterate from shared memory, not L2.  A warp owns
//   kRows rows and loads K 16 bytes a lane (4 fp32 or 8 bf16), kUnroll
//   column steps of its kRows rows in flight, through the read-only path
//   without L1 allocation.  Rows that do not start on 16 bytes (N not a
//   multiple of 4 fp32 / 8 bf16 elements) take an element path.  Iterate
//   buffers live in global memory, double-buffered, read through L2
//   (ld.cg); cg::this_grid().sync() between iterations.
// - block path (the paper's tens to hundreds of samples): one CTA per
//   problem, where the problem's K fits in the CTA's shared memory beside
//   both iterates (N up to 232 fp32, 328 bf16 in an H100's 227 KB).  K is
//   copied in once per launch and every iteration reads it from there:
//   `span` lanes share two rows, so an iterate vector read from shared
//   memory serves both, and the rows are padded so that a 16-byte load
//   meets no bank conflict.  What bounds this path is shared-memory
//   wavefronts and the barrier, not HBM.
//
// No atomics: each lambda is one warp's (or one span's) sum in a fixed
// order, and the fold sums each zl entry per CTA over its own rows, then
// over CTAs in order, so two launches on the same inputs agree bitwise.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "qp_common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro_qp::kRows;
using repro_qp::lane_sum;
using repro_qp::pg_update;
using repro_qp::warp_sum;

constexpr int kBlockThreads = 512;
constexpr int kSpanThreads = 256;
constexpr int kGridThreads = 256;
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kGridCtasPerSm = 2;
constexpr int kUnroll = 2;
// the grid path's iterate staging per CTA: two CTAs of it fit in one SM
constexpr int kStageBytes = 100 * 1024;

enum Path { kBlock = 0, kGrid = 1 };

// elements of K in 16 bytes
template <typename KT>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// 16 bytes of K, which no thread writes during the launch: the read-only
// path, no L1 allocation (a CTA reads each byte once per iteration)
__device__ __forceinline__ uint4 load_k16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes as the product's fp32 operands (bf16 -> fp32 is exact)
__device__ __forceinline__ void unpack(uint4 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x);
  x[1] = __uint_as_float(v.y);
  x[2] = __uint_as_float(v.z);
  x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    x[2 * j] = __uint_as_float(w[j] << 16);
    x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// acc + sum_j k[j] * l[j], in order; a bf16 x bf16 product is exact in fp32
template <int V>
__device__ __forceinline__ float dot16(uint4 k, const float (&l)[V],
                                       float acc) {
  float kv[V];
  unpack(k, kv);
#pragma unroll
  for (int j = 0; j < V; ++j) acc = fmaf(kv[j], l[j], acc);
  return acc;
}

__device__ __forceinline__ float load_k1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_k1(const __nv_bfloat16* p) {
  const unsigned short h = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// the iterate as the product sees it, in shared memory: fp32 as is, bf16
// rounded to nearest even (what torch's .to(bfloat16) does)
__device__ __forceinline__ void store_op(float* s, int i, float v) {
  s[i] = v;
}
__device__ __forceinline__ void store_op(__nv_bfloat16* s, int i, float v) {
  s[i] = __float2bfloat16(v);
}
__device__ __forceinline__ void store_op4(float* s, int i, float4 v) {
  *reinterpret_cast<float4*>(s + i) = v;
}
__device__ __forceinline__ void store_op4(__nv_bfloat16* s, int i, float4 v) {
  *reinterpret_cast<__nv_bfloat162*>(s + i) = __floats2bfloat162_rn(v.x, v.y);
  *reinterpret_cast<__nv_bfloat162*>(s + i + 2) =
      __floats2bfloat162_rn(v.z, v.w);
}
__device__ __forceinline__ float op_elem(const float* s, int i) {
  return s[i];
}
__device__ __forceinline__ float op_elem(const __nv_bfloat16* s, int i) {
  return __bfloat162float(s[i]);
}

// s[i] = operand(src[i]) for i < n.  src was written by other CTAs during
// the launch, so it is read through L2 (ld.cg), never a stale L1 line.
template <typename KT>
__device__ __forceinline__ void stage(KT* s, const float* src, int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n % 4 == 0) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      store_op4(s, 4 * i, __ldcg(src4 + i));
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      store_op(s, i, __ldcg(src + i));
  }
}

// acc[k] += this lane's share of sum_{c0 <= c < c1} K[row k, c] op[c - c0],
// the shares summed across the warp by repro_qp::warp_sum.  Vector path: every row,
// c0 and c1 on 16 bytes; a lane takes every 32nd 16-byte vector.
template <typename KT>
__device__ __forceinline__ void group_dot_vec(const KT* const (&rows)[kRows],
                                              const KT* op, int c0, int c1,
                                              float (&acc)[kRows]) {
  constexpr int V = Vec<KT>::n;
  constexpr int kStep = 32 * V;
  int c = c0 + (threadIdx.x % 32) * V;
  for (; c + (kUnroll - 1) * kStep < c1; c += kUnroll * kStep) {
    uint4 k[kUnroll][kRows];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        k[u][r] = load_k16(rows[r] + c + u * kStep);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float l[V];
      unpack(*reinterpret_cast<const uint4*>(op + (c + u * kStep - c0)), l);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = dot16(k[u][r], l, acc[r]);
    }
  }
  for (; c < c1; c += kStep) {
    uint4 k[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) k[r] = load_k16(rows[r] + c);
    float l[V];
    unpack(*reinterpret_cast<const uint4*>(op + (c - c0)), l);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = dot16(k[r], l, acc[r]);
  }
}

// The same sum, one element a lane per step: rows not on 16 bytes.  The
// loads of kElemSteps steps of the kRows rows are issued before their
// products, steps past c1 masked to a zero product (exact: the sums keep
// the column order and the bits of one step at a time).
template <typename KT>
__device__ __forceinline__ void group_dot_elem(
    const KT* const (&rows)[kRows], const KT* op, int c0, int c1,
    float (&acc)[kRows]) {
  constexpr int kElemSteps = 8;
  for (int c = c0 + threadIdx.x % 32; c < c1; c += kElemSteps * 32) {
    float k[kElemSteps][kRows];
    float l[kElemSteps];
#pragma unroll
    for (int u = 0; u < kElemSteps; ++u) {
      const int cu = c + u * 32;
      const bool in = cu < c1;
      l[u] = in ? op_elem(op, cu - c0) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        k[u][r] = in ? load_k1(rows[r] + cu) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kElemSteps; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(k[u][r], l[u], acc[r]);
  }
}

// Row pointers of the kRows rows from r0 (rows past the edge re-read the
// last row and are never written).
template <typename KT>
__device__ __forceinline__ void group_rows(const KT* Kb, int N, int r0,
                                           const KT* (&rows)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; ++k)
    rows[k] = Kb + (size_t)min(r0 + k, N - 1) * N;
}

// zl = Z^T lam of one problem (lam in shared memory, N entries).  With
// `cap` floats of free shared memory the CTA's threads split the rows
// into G groups per zl entry and add the G sums in order; else a thread
// per entry walks all N rows.
__device__ __forceinline__ void block_fold(const float* lam,
                                           const float* __restrict__ Zb,
                                           float* zl_b, int N, int D,
                                           float* scratch, int cap) {
  const int G = D > 0 ? min((int)blockDim.x / D, cap / D) : 1;
  if (G <= 1) {
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float s = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) s = fmaf(lam[n], Zb[(size_t)n * D + d], s);
      zl_b[d] = s;
    }
    return;
  }
  if (threadIdx.x < G * D) {
    const int g = threadIdx.x / D;
    const int d = threadIdx.x - g * D;
    float s = 0.f;
#pragma unroll 4
    for (int n = N * g / G; n < N * (g + 1) / G; ++n)
      s = fmaf(lam[n], Zb[(size_t)n * D + d], s);
    scratch[threadIdx.x] = s;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += scratch[g * D + d];
    zl_b[d] = s;
  }
}

// One CTA per problem.  Shared memory: two fp32 iterates and (bf16 mode)
// their bf16 operands, ld = N rounded up to 16 bytes of K each, the pad
// zero; then K, N rows ldk apart, the pad columns zero.  The launch is
// span * ceil(N/2) threads (rounded up to a warp): `span` lanes share rows
// p and p + ceil(N/2), so each iterate vector read from shared memory
// serves two rows; the lead lane keeps both rows' lambda, q and hi in
// registers and writes only the next iterate's operand to shared memory.
// ldk makes the rows that the 8 lanes of one 16-byte shared load touch
// fall on distinct banks.
template <typename KT, bool FOLD>
__global__ void __launch_bounds__(kBlockThreads)
qp_multi_block_kernel(const KT* __restrict__ K, const float* __restrict__ lam0,
                      const float* __restrict__ q,
                      const float* __restrict__ hi,
                      const float* __restrict__ gamma,
                      const float* __restrict__ Z, float* __restrict__ lam_out,
                      float* __restrict__ zl, int N, int D, int iters, int ld,
                      int ldk, int span, int vec_rows) {
  constexpr bool kF32 = std::is_same<KT, float>::value;
  constexpr int V = Vec<KT>::n;
  using Raw = std::conditional_t<kF32, float, unsigned short>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + ld;
  KT* cur_op;
  KT* nxt_op;
  if constexpr (kF32) {
    cur_op = cur;
    nxt_op = nxt;
  } else {
    cur_op = reinterpret_cast<KT*>(nxt + ld);
    nxt_op = cur_op + ld;
  }
  KT* Ks = nxt_op + ld;

  const int b = blockIdx.x;
  const size_t base = (size_t)b * N;
  const KT* Kb = K + base * N;
  const float g = gamma[b];

  for (int i = threadIdx.x; i < ld; i += blockDim.x) {
    const float v =
        i < N ? fminf(fmaxf(lam0[base + i], 0.f), hi[base + i]) : 0.f;
    cur[i] = v;
    nxt[i] = 0.f;
    if constexpr (!kF32) {
      store_op(cur_op, i, v);
      store_op(nxt_op, i, 0.f);
    }
  }
  // 16-byte units of the padded rows: K's, or zero past column N
  const int units = ldk / V;
  const int row_units = (N + V - 1) / V;
#pragma unroll 4
  for (int i = threadIdx.x; i < N * units; i += blockDim.x) {
    const int r = i / units;
    const int u = i - r * units;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (u < row_units) {
      const KT* src = Kb + (size_t)r * N + u * V;
      if (vec_rows) {
        x = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        Raw e[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          e[j] = u * V + j < N ? __ldg(reinterpret_cast<const Raw*>(src) + j)
                               : Raw(0);
        memcpy(&x, e, sizeof(x));
      }
    }
    *reinterpret_cast<uint4*>(Ks + (size_t)r * ldk + u * V) = x;
  }
  __syncthreads();

  const int half = (N + 1) / 2;
  const int p = threadIdx.x / span;
  const int part = threadIdx.x % span;
  const bool mine = p < half;
  const bool has1 = p + half < N;
  const bool lead = mine && part == 0;
  const int nvec = ld / V;
  const KT* row0 = Ks + (size_t)min(p, N - 1) * ldk;
  const KT* row1 = Ks + (size_t)min(p + half, N - 1) * ldk;
  float lam_a = 0.f, q_a = 0.f, hi_a = 0.f;
  float lam_b = 0.f, q_b = 0.f, hi_b = 0.f;
  if (lead) {
    lam_a = cur[p];
    q_a = q[base + p];
    hi_a = hi[base + p];
    if (has1) {
      lam_b = cur[p + half];
      q_b = q[base + p + half];
      hi_b = hi[base + p + half];
    }
  }
  for (int t = 0; t < iters; ++t) {
    float a0 = 0.f, a1 = 0.f;
    if (mine) {
      for (int v = part; v < nvec; v += span) {
        float l[V];
        unpack(*reinterpret_cast<const uint4*>(cur_op + v * V), l);
        a0 = dot16(*reinterpret_cast<const uint4*>(row0 + v * V), l, a0);
        a1 = dot16(*reinterpret_cast<const uint4*>(row1 + v * V), l, a1);
      }
    }
    for (int off = span / 2; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (lead) {
      lam_a = pg_update(lam_a, a0, q_a, hi_a, g);
      store_op(nxt_op, p, lam_a);
      if (has1) {
        lam_b = pg_update(lam_b, a1, q_b, hi_b, g);
        store_op(nxt_op, p + half, lam_b);
      }
    }
    __syncthreads();
    KT* tmp_op = cur_op;
    cur_op = nxt_op;
    nxt_op = tmp_op;
  }
  if (lead) {
    cur[p] = lam_a;
    if (has1) cur[p + half] = lam_b;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < N; i += blockDim.x) lam_out[base + i] = cur[i];
  if (FOLD) {
    // K is no longer read: its shared memory holds the fold's partial sums
    block_fold(cur, Z + base * D, zl + (size_t)b * D, N, D,
               reinterpret_cast<float*>(Ks),
               (int)((size_t)N * ldk * sizeof(KT) / sizeof(float)));
  }
}

// The first of CTA c's row groups: the batch's B * groups row groups, in
// problem order, split into gridDim.x contiguous ranges.
__device__ __forceinline__ long long first_group(long long total, int c) {
  return total * c / gridDim.x;
}

// buf: (2, B, N) iterate buffers; partial: (gridDim.x, slots, D) fold
// scratch, a slot per problem a CTA's range touches.  Both are written
// during the launch, so they are read through L2 (__ldcg) and carry no
// __restrict__.  Its shared memory holds `chunk` iterate entries in K's
// type.
template <typename KT, bool FOLD>
__global__ void __launch_bounds__(kGridThreads, kGridCtasPerSm)
qp_multi_grid_kernel(const KT* __restrict__ K, const float* __restrict__ lam0,
                     const float* __restrict__ q, const float* __restrict__ hi,
                     const float* __restrict__ gamma,
                     const float* __restrict__ Z, float* lam_out, float* zl,
                     float* buf, float* partial, int B, int N, int D,
                     int iters, int slots, int chunk, int vec_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  KT* op = reinterpret_cast<KT*>(smem);
  cg::grid_group grid = cg::this_grid();
  const size_t total = (size_t)B * N;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  float* cur = iters == 0 ? lam_out : buf;
  float* spare = buf + total;

  for (size_t i = tid; i < total; i += stride)
    cur[i] = fminf(fmaxf(lam0[i], 0.f), hi[i]);
  grid.sync();

  const int groups = (N + kRows - 1) / kRows;
  const long long total_groups = (long long)B * groups;
  const long long f_begin = first_group(total_groups, blockIdx.x);
  const long long f_end = first_group(total_groups, blockIdx.x + 1);
  // the problems this CTA's range touches, and its row groups in each
  const int b_first = (int)(f_begin / groups);
  const int b_last = (int)((f_end - 1) / groups);
  auto group_range = [&](int b, int& g_begin, int& g_end) {
    const long long first = (long long)b * groups;
    g_begin = f_begin > first ? (int)(f_begin - first) : 0;
    g_end = f_end < first + groups ? (int)(f_end - first) : groups;
  };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nchunks = (N + chunk - 1) / chunk;

  for (int t = 0; t < iters; ++t) {
    float* dst = t == iters - 1 ? lam_out : spare;
    for (int b = b_first; b <= b_last; ++b) {
      const size_t base = (size_t)b * N;
      const KT* Kb = K + base * N;
      const float g = gamma[b];
      int g_begin, g_end;
      group_range(b, g_begin, g_end);
      if (nchunks == 1) {
        __syncthreads();
        stage(op, cur + base, N);
        __syncthreads();
      }
      // a round gives each warp one row group; in chunks the CTA restages
      // the iterate per round, so its warps walk the rounds together
      for (int g0 = g_begin; g0 < g_end; g0 += kGridWarps) {
        const int gi = g0 + warp;
        const bool mine = gi < g_end;
        const int r0 = gi * kRows;
        const KT* rows[kRows];
        group_rows(Kb, N, r0, rows);
        float acc[kRows] = {};
        for (int c = 0; c < nchunks; ++c) {
          const int c0 = c * chunk;
          const int c1 = min(N, c0 + chunk);
          if (nchunks > 1) {
            __syncthreads();
            stage(op, cur + base + c0, c1 - c0);
            __syncthreads();
          }
          if (mine) {
            if (vec_rows)
              group_dot_vec(rows, op, c0, c1, acc);
            else
              group_dot_elem(rows, op, c0, c1, acc);
          }
        }
        if (mine) {
          warp_sum(acc);
          const float Klam = lane_sum(acc);
          const int r = r0 + lane;
          if (lane < kRows && r < N)
            dst[base + r] = pg_update(__ldcg(cur + base + r), Klam,
                                      q[base + r], hi[base + r], g);
        }
      }
    }
    grid.sync();
    spare = cur;
    cur = dst;
  }

  if (FOLD) {
    // each CTA over its own rows, then the CTAs of a problem in order
    for (int b = b_first; b <= b_last; ++b) {
      const size_t base = (size_t)b * N;
      int g_begin, g_end;
      group_range(b, g_begin, g_end);
      const int r_end = min(N, g_end * kRows);
      for (int d = threadIdx.x; d < D; d += blockDim.x) {
        float s = 0.f;
#pragma unroll 4
        for (int n = g_begin * kRows; n < r_end; ++n)
          s = fmaf(__ldcg(cur + base + n), Z[(base + n) * D + d], s);
        partial[((size_t)blockIdx.x * slots + (b - b_first)) * D + d] = s;
      }
    }
    grid.sync();
    for (size_t i = tid; i < (size_t)B * D; i += stride) {
      const int b = (int)(i / D);
      const size_t d = i % D;
      // the CTA whose range holds the problem's first group, then on
      const long long f = (long long)b * groups;
      int c = (int)(f * gridDim.x / total_groups);
      while (c + 1 < (int)gridDim.x && first_group(total_groups, c + 1) <= f)
        ++c;
      while (first_group(total_groups, c) > f) --c;
      float s = 0.f;
      for (; c < (int)gridDim.x && first_group(total_groups, c) < f + groups;
           ++c) {
        const int j = b - (int)(first_group(total_groups, c) / groups);
        s += __ldcg(partial + ((size_t)c * slots + j) * D + d);
      }
      zl[i] = s;
    }
  }
}

// Block path: lanes per pair of rows, span * ceil(N/2) <= kSpanThreads
// where N allows (fewer warps spend fewer instructions per iteration), at
// most a warp; the launch is span * ceil(N/2) threads rounded up to a warp
int block_span(int N) {
  const int pairs = (N + 1) / 2;
  int span = 1;
  while (span < 32 && 2 * span * pairs <= kSpanThreads) span *= 2;
  return span;
}

int block_threads(int N) {
  return round_up(block_span(N) * ((N + 1) / 2), 32);
}

// K's row stride in shared memory, in elements: N rounded up to 16
// bytes, then on to the stride whose rows put the 8 lanes of a 16-byte
// load (8 / span rows, span lanes each) on distinct banks
template <typename KT>
int k_stride(int N) {
  const int span = block_span(N);
  int ld = round_up(N, Vec<KT>::n);
  if (span < 8)
    while (ld * (int)sizeof(KT) % 128 != 16 * span) ld += Vec<KT>::n;
  return ld;
}

template <typename KT>
size_t block_smem(int N) {
  const size_t ld = round_up(N, Vec<KT>::n);
  size_t bytes = 2 * ld * sizeof(float);
  if (!std::is_same<KT, float>::value) bytes += 2 * ld * sizeof(KT);
  return bytes + (size_t)N * k_stride<KT>(N) * sizeof(KT);
}

// iterate entries a grid-path CTA stages at once (a multiple of 256)
template <typename KT>
int stage_chunk(int N) {
  return std::min(N, kStageBytes / (int)sizeof(KT));
}

template <typename KT, bool FOLD>
cudaError_t shape(int B, int N, int* path, int* blocks, int* slots,
                  int* smem) {
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  *slots = 1;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (block_smem<KT>(N) <= (size_t)optin && block_threads(N) <= kBlockThreads) {
    *path = kBlock;
    *smem = (int)block_smem<KT>(N);
    *blocks = B;
    return cudaSuccess;
  }
  *path = kGrid;
  *smem = round_up(stage_chunk<KT>(N) * (int)sizeof(KT), 16);
  auto kernel = qp_multi_grid_kernel<KT, FOLD>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kGridThreads, *smem);
  if (err != cudaSuccess) return err;
  const int resident = per_sm * sms;
  if (resident < 1) return cudaErrorLaunchOutOfResources;
  // with fewer problems than resident CTAs, as many CTAs per problem as
  // there are rounds of row groups (at most); else every resident CTA
  const int groups = (N + kRows - 1) / kRows;
  *blocks = B >= resident
                ? resident
                : B * std::min(resident / B,
                               (groups + kGridWarps - 1) / kGridWarps);
  // the most problems one CTA's range touches
  const long long total = (long long)B * groups;
  for (int c = 0; c < *blocks; ++c) {
    const long long f0 = total * c / *blocks;
    const long long f1 = total * (c + 1) / *blocks;
    *slots = std::max(*slots, (int)((f1 - 1) / groups - f0 / groups + 1));
  }
  return cudaSuccess;
}

template <typename KT, bool FOLD>
cudaError_t launch(const KT* K, const float* lam0, const float* q,
                   const float* hi, const float* gamma, const float* Z,
                   float* lam_out, float* zl, float* buf, float* partial,
                   int B, int N, int D, int iters, int path, int blocks,
                   int slots, int smem, cudaStream_t stream) {
  const int vec_rows = N % Vec<KT>::n == 0 &&
                       reinterpret_cast<uintptr_t>(K) % 16 == 0;
  if (path == kBlock) {
    auto kernel = qp_multi_block_kernel<KT, FOLD>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, block_threads(N), smem, stream>>>(
        K, lam0, q, hi, gamma, Z, lam_out, zl, N, D, iters,
        round_up(N, Vec<KT>::n), k_stride<KT>(N), block_span(N), vec_rows);
    return cudaGetLastError();
  }
  int chunk = stage_chunk<KT>(N);
  void* args[] = {(void*)&K,       (void*)&lam0,  (void*)&q,
                  (void*)&hi,      (void*)&gamma, (void*)&Z,
                  (void*)&lam_out, (void*)&zl,    (void*)&buf,
                  (void*)&partial, (void*)&B,     (void*)&N,
                  (void*)&D,       (void*)&iters, (void*)&slots,
                  (void*)&chunk,   (void*)&vec_rows};
  return cudaLaunchCooperativeKernel((void*)qp_multi_grid_kernel<KT, FOLD>,
                                     dim3(blocks), dim3(kGridThreads), args,
                                     smem, stream);
}

}  // namespace

// The launch shape for B problems of N rows: `path` 0 (one CTA per
// problem, K in shared memory) or 1 (the cooperative grid); its CTAs, the
// most problems one CTA's rows touch (`slots`) and its dynamic shared
// bytes.  The caller sizes `buf` (2*B*N, grid path) and `partial`
// (blocks*slots*D, grid path with the fold) from it.
cudaError_t repro_qp_multi_shape(int k_bf16, int fold, int B, int N,
                                 int* path, int* blocks, int* slots,
                                 int* smem) {
  if (B == 0 || N == 0) {
    *path = kBlock;
    *blocks = *slots = 1;
    *smem = 0;
    return cudaSuccess;
  }
  return k_bf16 ? (fold ? shape<__nv_bfloat16, true>(B, N, path, blocks,
                                                     slots, smem)
                        : shape<__nv_bfloat16, false>(B, N, path, blocks,
                                                      slots, smem))
                : (fold ? shape<float, true>(B, N, path, blocks, slots,
                                             smem)
                        : shape<float, false>(B, N, path, blocks,
                                              slots, smem));
}

// K (B, N, N) fp32 or bf16 (k_bf16); lam0, q, hi, lam_out (B, N); gamma
// (B,); Z (B, N, D) and zl (B, D) when fold; the shape and the scratch as
// repro_qp_multi_shape gives them.
cudaError_t repro_qp_multi_launch(int k_bf16, int fold, const void* K,
                                  const float* lam0, const float* q,
                                  const float* hi, const float* gamma,
                                  const float* Z, float* lam_out, float* zl,
                                  float* buf, float* partial, int B, int N,
                                  int D, int iters, int path, int blocks,
                                  int slots, int smem,
                                  cudaStream_t stream) {
  if (B == 0 || N == 0) return cudaSuccess;
  if (k_bf16) {
    const __nv_bfloat16* Kh = static_cast<const __nv_bfloat16*>(K);
    return fold ? launch<__nv_bfloat16, true>(
                      Kh, lam0, q, hi, gamma, Z, lam_out, zl, buf, partial,
                      B, N, D, iters, path, blocks, slots, smem, stream)
                : launch<__nv_bfloat16, false>(
                      Kh, lam0, q, hi, gamma, Z, lam_out, zl, buf, partial,
                      B, N, D, iters, path, blocks, slots, smem,
                      stream);
  }
  const float* Kf = static_cast<const float*>(K);
  return fold ? launch<float, true>(Kf, lam0, q, hi, gamma, Z, lam_out, zl,
                                    buf, partial, B, N, D, iters, path,
                                    blocks, slots, smem, stream)
              : launch<float, false>(Kf, lam0, q, hi, gamma, Z, lam_out, zl,
                                     buf, partial, B, N, D, iters, path,
                                     blocks, slots, smem, stream);
}

namespace {

struct Instance {
  const char* name;
  const void* fn;
};

const Instance kInstances[] = {
    {"qp_multi_block_kernel<f32>",
     (const void*)qp_multi_block_kernel<float, false>},
    {"qp_multi_block_kernel<f32,fold>",
     (const void*)qp_multi_block_kernel<float, true>},
    {"qp_multi_block_kernel<bf16>",
     (const void*)qp_multi_block_kernel<__nv_bfloat16, false>},
    {"qp_multi_block_kernel<bf16,fold>",
     (const void*)qp_multi_block_kernel<__nv_bfloat16, true>},
    {"qp_multi_grid_kernel<f32>",
     (const void*)qp_multi_grid_kernel<float, false>},
    {"qp_multi_grid_kernel<f32,fold>",
     (const void*)qp_multi_grid_kernel<float, true>},
    {"qp_multi_grid_kernel<bf16>",
     (const void*)qp_multi_grid_kernel<__nv_bfloat16, false>},
    {"qp_multi_grid_kernel<bf16,fold>",
     (const void*)qp_multi_grid_kernel<__nv_bfloat16, true>},
};

}  // namespace

cudaError_t repro_qp_multi_attributes(int which, cudaFuncAttributes* attr,
                                      const char** name) {
  if (which < 0 || which >= (int)(sizeof(kInstances) / sizeof(kInstances[0])))
    return cudaErrorInvalidValue;
  *name = kInstances[which].name;
  return cudaFuncGetAttributes(attr, kInstances[which].fn);
}
