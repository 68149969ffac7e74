// PyTorch binding of the BVH8 traversal kernel (traverse_tris.cu).
// Only this file includes torch headers; the kernel file stays plain CUDA.

#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

extern "C" void corona13_traverse_tris(
    const float* wbounds, const int* wlinks, const float* leaf,
    const float* org, const float* dir, const float* inv,
    const float* t_init, const int* ignore1, const int* ignore2, int n,
    float* t_out, int* prim_out, float* u_out, float* v_out, int* slot_out,
    int any_hit, cudaStream_t stream);

namespace {

void check(const torch::Tensor& x, const char* name, torch::ScalarType dtype,
           const torch::Tensor& ref) {
  TORCH_CHECK(x.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(x.device() == ref.device(), name, " is on another device");
  TORCH_CHECK(x.scalar_type() == dtype, name, " has the wrong dtype");
  TORCH_CHECK(x.is_contiguous(), name, " must be contiguous");
}

std::vector<torch::Tensor> traverse_tris(
    torch::Tensor wbounds, torch::Tensor wlinks, torch::Tensor leaf,
    torch::Tensor org, torch::Tensor dir, torch::Tensor inv,
    torch::Tensor t_init, torch::Tensor ignore1, torch::Tensor ignore2,
    bool any_hit) {
  const auto f32 = torch::kFloat32;
  const auto i32 = torch::kInt32;
  check(wbounds, "wbounds", f32, org);
  check(wlinks, "wlinks", i32, org);
  check(leaf, "leaf_packed", f32, org);
  check(org, "org", f32, org);
  check(dir, "direction", f32, org);
  check(inv, "inv_dir", f32, org);
  check(t_init, "t_init", f32, org);
  check(ignore1, "ignore_prim", i32, org);
  check(ignore2, "ignore_prim2", i32, org);
  const int64_t n = org.size(0);
  TORCH_CHECK(n > 0 && n < (int64_t(1) << 31), "ray count out of range");
  TORCH_CHECK(org.dim() == 2 && org.size(1) == 3, "org must be [N, 3]");
  TORCH_CHECK(dir.sizes() == org.sizes() && inv.sizes() == org.sizes(),
              "direction/inv_dir must be [N, 3]");
  TORCH_CHECK(t_init.dim() == 1 && t_init.size(0) == n, "t_init must be [N]");
  TORCH_CHECK(ignore1.dim() == 1 && ignore1.size(0) == n &&
              ignore2.dim() == 1 && ignore2.size(0) == n,
              "ignore_prim(2) must be [N]");
  TORCH_CHECK(wbounds.dim() == 3 && wbounds.size(1) == 8 &&
              wbounds.size(2) == 8, "wbounds must be [Wn, 8, 8]");
  TORCH_CHECK(wlinks.dim() == 1 && wlinks.size(0) == wbounds.size(0) * 8,
              "wlinks must be [Wn * 8]");
  TORCH_CHECK(leaf.dim() == 3 && leaf.size(1) == 8 && leaf.size(2) == 16,
              "leaf_packed must be [n_leaves, 8, 16]");

  const c10::cuda::CUDAGuard guard(org.device());
  auto t = torch::empty({n}, org.options());
  auto u = torch::empty({n}, org.options());
  auto v = torch::empty({n}, org.options());
  auto prim = torch::empty({n}, org.options().dtype(i32));
  auto slot = torch::empty({n}, org.options().dtype(i32));
  corona13_traverse_tris(
      wbounds.data_ptr<float>(), wlinks.data_ptr<int>(), leaf.data_ptr<float>(),
      org.data_ptr<float>(), dir.data_ptr<float>(), inv.data_ptr<float>(),
      t_init.data_ptr<float>(), ignore1.data_ptr<int>(),
      ignore2.data_ptr<int>(), (int)n, t.data_ptr<float>(),
      prim.data_ptr<int>(), u.data_ptr<float>(), v.data_ptr<float>(),
      slot.data_ptr<int>(), any_hit ? 1 : 0,
      c10::cuda::getCurrentCUDAStream().stream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
  return {t, prim, u, v, slot};
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("traverse_tris", &traverse_tris,
        "BVH8 closest-hit / any-hit triangle traversal (CUDA)");
}
