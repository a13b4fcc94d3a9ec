// The launch floor of one serving batch, for timing only (chip_smoke.py
// phase 6); nothing on the port's paths calls it. It issues what one
// glmix_margin_launch call issues (csrc/gather_margin.cu: the staged copy
// in, a launch on the same grid of 8 warps a block, the [B] result back)
// around a kernel that does nothing, so its time is the least a batch can
// cost with one launch.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; returns the
// first CUDA error of its calls.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 rows of one warp each, as the margin
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

}  // namespace

// host_in / host_out may be null (no copy): with both null the call is
// the empty launch alone. B >= 1.
extern "C" int empty_margin_launch(const void* host_in, void* dev_in,
                                   long long in_bytes, void* out,
                                   void* host_out, long long B,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (host_in != nullptr && in_bytes > 0) {
    err = cudaMemcpyAsync(dev_in, host_in, static_cast<size_t>(in_bytes),
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  empty_kernel<<<static_cast<unsigned int>(
                     (B + kRowsPerBlock - 1) / kRowsPerBlock),
                 kThreads, 0, s>>>();
  err = cudaGetLastError();
  if (err != cudaSuccess || host_out == nullptr) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(
      host_out, out, static_cast<size_t>(B) * sizeof(float),
      cudaMemcpyDeviceToHost, s));
}
