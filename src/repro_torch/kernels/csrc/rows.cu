// The serving product of a fitted network: the decision values of a batch
// of rows against every hyperplane,
//
//     G[i, k] = bf[k] + sum_j X[i, j] * Wf[k, j],   j = 0, 1, ..., p-1
//
// Not a TPU kernel: the reference leaves X @ Wf.T + bf to XLA
// (repro/serve/model.py:gemm_rows).  Its serving contract needs a row's
// values to be bitwise the same in every padded bucket and with any rows
// batched beside it, so the order of the sum must not depend on the
// batch.  A library GEMM does not promise that: it may choose another
// algorithm, and another split of the sum, for another number of rows.
// Here every output element is one thread's chain of fmaf over j in
// order, whatever the number of rows or the element's place.
//
// What bounds it on an H100: at the server's shapes (at most 1024 rows,
// a few dozen hyperplanes, p up to a few hundred) its bytes, about
// 4 (M p + K p + M K), a megabyte at most, and in practice the launch.
// The hyperplanes and biases are staged in shared memory where they fit
// (K (p + 1) floats up to 48 KB), so each block reads them once from
// device memory; a thread's row of X is read through the L1, which the
// threads of one row share (a warp spans few rows, as K is small).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStagedFloats = 48 * 1024 / 4;

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ W, const float* __restrict__ b,
            const float* __restrict__ X, float* __restrict__ out, int M,
            int K, int p) {
  extern __shared__ float staged[];
  const float* Wk = W;
  const float* bk = b;
  if (kStaged) {
    const int nw = K * p;
    for (int t = threadIdx.x; t < nw + K; t += kThreads)
      staged[t] = t < nw ? W[t] : b[t - nw];
    __syncthreads();
    Wk = staged;
    bk = staged + nw;
  }
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)M * K) return;
  const int i = (int)(e / K);
  const int k = (int)(e % K);
  const float* x = X + (size_t)i * p;
  const float* w = Wk + (size_t)k * p;
  float acc = bk[k];
  for (int j = 0; j < p; ++j) acc = fmaf(x[j], w[j], acc);
  out[e] = acc;
}

bool fits(int K, int p) { return (long long)K * (p + 1) <= kStagedFloats; }

}  // namespace

// W (K, p), b (K,), X (M, p) -> out (M, K): fp32, contiguous.
cudaError_t repro_rows_launch(const float* W, const float* b, const float* X,
                              float* out, int M, int K, int p,
                              cudaStream_t stream) {
  if (M == 0 || K == 0) return cudaSuccess;
  const long long n = (long long)M * K;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (fits(K, p)) {
    const size_t smem = sizeof(float) * ((size_t)K * p + K);
    rows_kernel<true><<<blocks, kThreads, smem, stream>>>(W, b, X, out, M, K,
                                                          p);
  } else {
    rows_kernel<false><<<blocks, kThreads, 0, stream>>>(W, b, X, out, M, K,
                                                        p);
  }
  return cudaGetLastError();
}

cudaError_t repro_rows_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name) {
  if (which == 0) {
    *name = "rows_kernel<staged>";
    return cudaFuncGetAttributes(attr, rows_kernel<true>);
  }
  if (which == 1) {
    *name = "rows_kernel<global>";
    return cudaFuncGetAttributes(attr, rows_kernel<false>);
  }
  return cudaErrorInvalidValue;
}
