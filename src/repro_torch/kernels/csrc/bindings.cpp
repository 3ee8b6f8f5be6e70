// PyTorch bindings of the hand kernels.  The only source that includes
// PyTorch's headers: the .cu files expose plain C launchers, so nvcc never
// compiles torch/extension.h.  Each binding checks device, type, shape and
// contiguity, allocates the outputs and any scratch with torch, launches
// on PyTorch's current stream and checks the launch.
#include <torch/extension.h>

#include <pybind11/stl.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime_api.h>

#include <limits>
#include <optional>
#include <string>
#include <tuple>
#include <vector>

int repro_gram_ld(int n);
int repro_gram_max_rows();
cudaError_t repro_gram_prescale_launch(const float* Z, const float* a,
                                       float* Zs, int B, int N, int D,
                                       cudaStream_t stream);
cudaError_t repro_gram_launch(const float* Zs, float* K, int B, int N, int D,
                              cudaStream_t stream);
cudaError_t repro_gram_tiled_launch(const float* Zs, float* out,
                                    size_t out_batch_stride, size_t ldo,
                                    int B, int N, int D, int row0, int M,
                                    cudaStream_t stream);
cudaError_t repro_gram_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name);
cudaError_t repro_qp_step_launch(const float* K, const float* lam,
                                 const float* q, const float* hi,
                                 const float* gamma, float* out, int B, int N,
                                 cudaStream_t stream);
cudaError_t repro_qp_step_attributes(int which, cudaFuncAttributes* attr,
                                     const char** name);
cudaError_t repro_qp_multi_shape(int k_bf16, int fold, int B, int N,
                                 int* path, int* blocks, int* slots,
                                 int* smem);
cudaError_t repro_qp_multi_launch(int k_bf16, int fold, const void* K,
                                  const float* lam0, const float* q,
                                  const float* hi, const float* gamma,
                                  const float* Z, float* lam_out, float* zl,
                                  float* buf, float* partial, int B, int N,
                                  int D, int iters, int path, int blocks,
                                  int slots, int smem,
                                  cudaStream_t stream);
cudaError_t repro_qp_multi_attributes(int which, cudaFuncAttributes* attr,
                                      const char** name);
cudaError_t repro_rows_launch(const float* W, const float* b, const float* X,
                              float* out, int M, int K, int p,
                              cudaStream_t stream);
cudaError_t repro_rows_attributes(int which, cudaFuncAttributes* attr,
                                  const char** name);

namespace {

// An operand a kernel does not take raises ValueError (TORCH_CHECK_VALUE),
// a CUDA error RuntimeError (C10_CUDA_CHECK).

void check(const torch::Tensor& t, const char* name, at::ScalarType dtype,
           int64_t dim) {
  TORCH_CHECK_VALUE(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK_VALUE(t.scalar_type() == dtype, name, " must be ", dtype,
                    ", got ", t.scalar_type());
  TORCH_CHECK_VALUE(t.dim() == dim, name, " must have ", dim,
                    " dims, got ", t.dim());
  TORCH_CHECK_VALUE(t.is_contiguous(), name, " must be contiguous");
}

int as_int(int64_t v, const char* what) {
  TORCH_CHECK_VALUE(v >= 0 && v <= std::numeric_limits<int>::max(), what,
                    " out of range: ", v);
  return static_cast<int>(v);
}

// Z (B, N, D), a (B, D) -> Zs (2, B, D, N): Z feature-major, Zs[0]
// unscaled and Zs[1] scaled by a, a view whose rows lie
// repro_gram_ld(N) floats apart (no kernel reads the columns past N)
torch::Tensor gram_prescale(torch::Tensor Z, torch::Tensor a) {
  check(Z, "Z", at::kFloat, 3);
  check(a, "a", at::kFloat, 2);
  const int64_t B = Z.size(0), N = Z.size(1), D = Z.size(2);
  TORCH_CHECK_VALUE(a.size(0) == B && a.size(1) == D, "a must be (B, D)");
  TORCH_CHECK_VALUE(a.device() == Z.device(),
                    "operands must be on one device");
  TORCH_CHECK_VALUE(B <= 65535, "batch of ", B,
                    " problems exceeds the grid");
  TORCH_CHECK_VALUE(N <= repro_gram_max_rows(), N, " rows exceed the grid");
  TORCH_CHECK_VALUE(D <= 65535 * 32, D, " features exceed the grid");
  const c10::cuda::CUDAGuard guard(Z.device());
  auto Zs = torch::empty({2, B, D, repro_gram_ld(static_cast<int>(N))},
                         Z.options());
  C10_CUDA_CHECK(repro_gram_prescale_launch(
      Z.data_ptr<float>(), a.data_ptr<float>(), Zs.data_ptr<float>(),
      as_int(B, "B"), as_int(N, "N"), as_int(D, "D"),
      c10::cuda::getCurrentCUDAStream()));
  return Zs.narrow(3, 0, N);
}

// Zs: gram_prescale's (2, B, D, N) view of Z (B, N, D), which carries N
void check_prescaled(const torch::Tensor& Zs) {
  TORCH_CHECK_VALUE(Zs.is_cuda() && Zs.scalar_type() == at::kFloat &&
                        Zs.dim() == 4 && Zs.size(0) == 2,
                    "Zs must be gram_prescale's float32 CUDA (2, B, D, N)");
  const int64_t B = Zs.size(1), D = Zs.size(2), N = Zs.size(3);
  TORCH_CHECK_VALUE(N <= repro_gram_max_rows(), N, " rows exceed the grid");
  TORCH_CHECK_VALUE(B <= 65535, "batch of ", B,
                    " problems exceeds the grid");
  const int64_t ld = repro_gram_ld(static_cast<int>(N));
  TORCH_CHECK_VALUE(
      Zs.numel() == 0 ||
          (Zs.stride(3) == 1 && Zs.stride(2) == ld &&
           Zs.stride(1) == D * ld && Zs.stride(0) == B * D * ld),
      "Zs must be gram_prescale's (2, B, D, N) view, rows ", ld,
      " floats apart");
}

// Zs of Z (B, N, D) -> K (B, N, N)
torch::Tensor weighted_gram(torch::Tensor Zs) {
  check_prescaled(Zs);
  const int64_t B = Zs.size(1), D = Zs.size(2), N = Zs.size(3);
  const c10::cuda::CUDAGuard guard(Zs.device());
  auto K = torch::empty({B, N, N}, Zs.options());
  C10_CUDA_CHECK(repro_gram_launch(Zs.data_ptr<float>(), K.data_ptr<float>(),
                                   as_int(B, "B"), as_int(N, "N"),
                                   as_int(D, "D"),
                                   c10::cuda::getCurrentCUDAStream()));
  return K;
}

// Zs of Z (B, N, D) -> rows [row0, row0 + M) of K written into out
// (B, M, N), a view whose rows may be strided (e.g. rows [s, s+M) of a
// (B, N, N) K)
void weighted_gram_tiled(torch::Tensor Zs, int64_t row0, torch::Tensor out) {
  check_prescaled(Zs);
  const int64_t B = Zs.size(1), D = Zs.size(2), N = Zs.size(3);
  TORCH_CHECK_VALUE(out.is_cuda() && out.scalar_type() == at::kFloat &&
                        out.dim() == 3,
                    "out must be a float32 CUDA tensor of 3 dims");
  const int64_t M = out.size(1);
  TORCH_CHECK_VALUE(out.size(0) == B && out.size(2) == N, "out must be (",
                    B, ", M, ", N, ") for Zs of ", N, " rows");
  TORCH_CHECK_VALUE(row0 >= 0 && row0 + M <= N, "rows [", row0, ", ",
                    row0 + M, ") are not rows of a ", N, "-row K");
  TORCH_CHECK_VALUE(out.stride(2) == 1 && out.stride(1) >= N &&
                        (B == 1 || out.stride(0) >= M * out.stride(1)),
                    "out must have unit column stride and rows that do "
                    "not overlap");
  TORCH_CHECK_VALUE(out.device() == Zs.device(),
                    "operands must be on one device");
  const c10::cuda::CUDAGuard guard(Zs.device());
  C10_CUDA_CHECK(repro_gram_tiled_launch(
      Zs.data_ptr<float>(), out.data_ptr<float>(),
      static_cast<size_t>(out.stride(0)), static_cast<size_t>(out.stride(1)),
      as_int(B, "B"), as_int(N, "N"), as_int(D, "D"), as_int(row0, "row0"),
      as_int(M, "M"), c10::cuda::getCurrentCUDAStream()));
}

// lam, q, hi (B, N), K (B, N, N), gamma (B,) -> lam (B, N)
torch::Tensor qp_pg_step(torch::Tensor lam, torch::Tensor K, torch::Tensor q,
                         torch::Tensor hi, torch::Tensor gamma) {
  check(lam, "lam", at::kFloat, 2);
  check(K, "K", at::kFloat, 3);
  check(q, "q", at::kFloat, 2);
  check(hi, "hi", at::kFloat, 2);
  check(gamma, "gamma", at::kFloat, 1);
  const int64_t B = lam.size(0), N = lam.size(1);
  TORCH_CHECK_VALUE(K.size(0) == B && K.size(1) == N && K.size(2) == N,
                    "K must be (B, N, N)");
  TORCH_CHECK_VALUE(q.sizes() == lam.sizes() && hi.sizes() == lam.sizes(),
                    "q and hi must be (B, N)");
  TORCH_CHECK_VALUE(gamma.size(0) == B, "gamma must be (B,)");
  TORCH_CHECK_VALUE(B <= 65535, "batch of ", B,
                    " problems exceeds the grid");
  const c10::cuda::CUDAGuard guard(lam.device());
  auto out = torch::empty_like(lam);
  C10_CUDA_CHECK(repro_qp_step_launch(
      K.data_ptr<float>(), lam.data_ptr<float>(), q.data_ptr<float>(),
      hi.data_ptr<float>(), gamma.data_ptr<float>(), out.data_ptr<float>(),
      as_int(B, "B"), as_int(N, "N"), c10::cuda::getCurrentCUDAStream()));
  return out;
}

// lam0, q, hi (B, N), K (B, N, N) fp32 or bf16, gamma (B,), optional
// Z (B, N, D) -> [lam (B, N)] or [lam, zl (B, D)]
std::vector<torch::Tensor> qp_pg_multi(torch::Tensor lam0, torch::Tensor K,
                                       torch::Tensor q, torch::Tensor hi,
                                       torch::Tensor gamma,
                                       std::optional<torch::Tensor> Z,
                                       int64_t iters) {
  check(lam0, "lam0", at::kFloat, 2);
  TORCH_CHECK_VALUE(K.scalar_type() == at::kFloat ||
                        K.scalar_type() == at::kBFloat16,
                    "K must be float32 or bfloat16");
  check(K, "K", K.scalar_type(), 3);
  check(q, "q", at::kFloat, 2);
  check(hi, "hi", at::kFloat, 2);
  check(gamma, "gamma", at::kFloat, 1);
  const int64_t B = lam0.size(0), N = lam0.size(1);
  TORCH_CHECK_VALUE(K.size(0) == B && K.size(1) == N && K.size(2) == N,
                    "K must be (B, N, N)");
  TORCH_CHECK_VALUE(q.sizes() == lam0.sizes() && hi.sizes() == lam0.sizes(),
                    "q and hi must be (B, N)");
  TORCH_CHECK_VALUE(gamma.size(0) == B, "gamma must be (B,)");
  const bool fold = Z.has_value();
  int64_t D = 0;
  if (fold) {
    check(*Z, "Z", at::kFloat, 3);
    TORCH_CHECK_VALUE(Z->size(0) == B && Z->size(1) == N,
                      "Z must be (B, N, D)");
    D = Z->size(2);
  }
  const int k_bf16 = K.scalar_type() == at::kBFloat16;
  const c10::cuda::CUDAGuard guard(lam0.device());
  int path = 0, blocks = 0, slots = 0, smem = 0;
  C10_CUDA_CHECK(repro_qp_multi_shape(k_bf16, fold, as_int(B, "B"),
                                      as_int(N, "N"), &path, &blocks,
                                      &slots, &smem));
  const bool grid = path == 1;
  auto lam = torch::empty_like(lam0);
  auto zl = torch::empty({fold ? B : 0, D}, lam0.options());
  auto buf = torch::empty({grid ? 2 * B * N : 0}, lam0.options());
  auto partial = torch::empty({fold && grid ? blocks * slots * D : 0},
                              lam0.options());
  C10_CUDA_CHECK(repro_qp_multi_launch(
      k_bf16, fold, K.data_ptr(), lam0.data_ptr<float>(), q.data_ptr<float>(),
      hi.data_ptr<float>(), gamma.data_ptr<float>(),
      fold ? Z->data_ptr<float>() : nullptr, lam.data_ptr<float>(),
      fold ? zl.data_ptr<float>() : nullptr, buf.data_ptr<float>(),
      partial.data_ptr<float>(), as_int(B, "B"), as_int(N, "N"),
      as_int(D, "D"), as_int(iters, "iters"), path, blocks, slots,
      smem, c10::cuda::getCurrentCUDAStream()));
  if (fold) return {lam, zl};
  return {lam};
}

// The multi solve's launch on the current device for B problems of N rows:
// (path: 0 one CTA per problem with K in shared memory, 1 the cooperative
// grid; CTAs; the most problems one CTA's rows touch; dynamic shared bytes
// per CTA)
std::tuple<int, int, int, int> qp_multi_shape(bool k_bf16, bool fold,
                                              int64_t B, int64_t N) {
  int path = 0, blocks = 0, slots = 0, smem = 0;
  C10_CUDA_CHECK(repro_qp_multi_shape(k_bf16, fold, as_int(B, "B"),
                                      as_int(N, "N"), &path, &blocks,
                                      &slots, &smem));
  return {path, blocks, slots, smem};
}

// Wf (K, p), bf (K,), X (M, p) -> G (M, K), each element summed in an
// order that depends on p alone: a lane group per row, each lane's fmaf
// chain over its chunks of four features, a fixed xor butterfly (rows.cu)
torch::Tensor gemm_rows(torch::Tensor Wf, torch::Tensor bf, torch::Tensor X) {
  check(Wf, "Wf", at::kFloat, 2);
  check(bf, "bf", at::kFloat, 1);
  check(X, "X", at::kFloat, 2);
  const int64_t K = Wf.size(0), p = Wf.size(1), M = X.size(0);
  TORCH_CHECK_VALUE(bf.size(0) == K, "bf must be (K,) for Wf (K, p)");
  TORCH_CHECK_VALUE(X.size(1) == p, "X must be (M, ", p, ")");
  TORCH_CHECK_VALUE(X.device() == Wf.device() && bf.device() == Wf.device(),
                    "operands must be on one device");
  TORCH_CHECK_VALUE(M * K <= std::numeric_limits<int>::max(), M, " rows of ",
                    K, " values exceed the grid");
  const c10::cuda::CUDAGuard guard(X.device());
  auto out = torch::empty({M, K}, X.options());
  C10_CUDA_CHECK(repro_rows_launch(
      Wf.data_ptr<float>(), bf.data_ptr<float>(), X.data_ptr<float>(),
      out.data_ptr<float>(), as_int(M, "M"), as_int(K, "K"), as_int(p, "p"),
      c10::cuda::getCurrentCUDAStream()));
  return out;
}

// Registers, shared and local (spill) memory of every kernel instance, as
// the compiler left them.
std::vector<std::tuple<std::string, int, int64_t, int64_t, int>>
kernel_info() {
  using Query = cudaError_t (*)(int, cudaFuncAttributes*, const char**);
  const Query queries[] = {repro_gram_attributes, repro_qp_step_attributes,
                           repro_qp_multi_attributes, repro_rows_attributes};
  std::vector<std::tuple<std::string, int, int64_t, int64_t, int>> out;
  for (Query query : queries) {
    for (int which = 0;; ++which) {
      cudaFuncAttributes attr;
      const char* name = nullptr;
      const cudaError_t err = query(which, &attr, &name);
      if (err == cudaErrorInvalidValue && name == nullptr) {
        cudaGetLastError();  // the end of this source's list
        break;
      }
      C10_CUDA_CHECK(err);
      out.emplace_back(name, attr.numRegs,
                       static_cast<int64_t>(attr.sharedSizeBytes),
                       static_cast<int64_t>(attr.localSizeBytes),
                       attr.maxThreadsPerBlock);
    }
  }
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("gram_prescale", &gram_prescale,
        "Z feature-major, unscaled and scaled by a, for the Gram kernels");
  m.def("weighted_gram", &weighted_gram, "K = Z diag(a) Z^T, batched");
  m.def("weighted_gram_tiled", &weighted_gram_tiled,
        "rows [row0, row0 + M) of K, batched, into a given output view");
  m.def("qp_pg_step", &qp_pg_step, "one fused PG step, batched");
  m.def("qp_pg_multi", &qp_pg_multi, "the fused multi-iteration PG solve",
        pybind11::arg("lam0"), pybind11::arg("K"), pybind11::arg("q"),
        pybind11::arg("hi"), pybind11::arg("gamma"), pybind11::arg("Z"),
        pybind11::arg("iters"));
  m.def("qp_multi_shape", &qp_multi_shape,
        "(path, CTAs, problems per CTA, dynamic shared bytes) of the multi "
        "solve's launch");
  m.def("gemm_rows", &gemm_rows,
        "decision values of rows against every hyperplane, fixed order");
  m.def("kernel_info", &kernel_info,
        "(name, registers, static shared bytes, local bytes, max threads)");
}
