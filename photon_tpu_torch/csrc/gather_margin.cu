// Fixed-effect serving margin: out[b] = off[b] + sum_j val[b,j] * theta[idx[b,j]].
//
// Replaces the TPU kernel photon_tpu/ops/pallas_glm.py::_fused_margin
// (wrapper fused_gather_margin). The Pallas kernel expands each 128-row
// request tile into a dense one-hot [tile, D] block in VMEM and runs one
// MXU contraction against theta; that expansion is a TPU device and is
// not carried over. Here the same function is computed directly:
//
//   * one warp per request row, 8 rows per 256-thread block;
//   * lanes stride over the K slots, so each warp's idx/val loads are
//     coalesced 128-byte transactions;
//   * theta is read through the read-only data cache (__ldg); a serving
//     model's theta is small and stays cached across the batch;
//   * an index outside [0, D) adds 0 — the Pallas semantics, where such
//     an index matches no one-hot column — so pad slots (0, 0.0) and any
//     stray index are inert, and no D limit applies (the TPU's
//     D <= 4096 VMEM bound is dropped);
//   * each lane accumulates in a fixed order, then a fixed warp-shuffle
//     tree sums the lanes, then + off. There is no cross-block reduction
//     and no atomic, so results are bitwise identical run to run.
//
// Bound on this card: bytes. Per call it must move B*K*8 (idx + val)
// + B*8 (off in, out) + D*4 (theta) bytes, against 2*B*K flops.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; the
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;

__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
gather_margin_kernel(const int32_t* __restrict__ idx,
                     const float* __restrict__ val,
                     const float* __restrict__ off,
                     const float* __restrict__ theta,
                     float* __restrict__ out,
                     int64_t B, int64_t K, int64_t D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // the whole warp shares one row, so it leaves together and the full
  // shuffle mask below stays valid
  if (row >= B) return;
  const int32_t* ri = idx + row * K;
  const float* rv = val + row * K;
  float acc = 0.0f;
  for (int64_t j = lane; j < K; j += kWarp) {
    const int32_t c = __ldg(ri + j);
    const float v = __ldg(rv + j);
    if (c >= 0 && static_cast<int64_t>(c) < D) {
      acc = fmaf(v, __ldg(theta + c), acc);
    }
  }
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, s);
  }
  if (lane == 0) {
    out[row] = acc + (off != nullptr ? off[row] : 0.0f);
  }
}

}  // namespace

// idx [B, K] int32, val [B, K] f32, off [B] f32 or null, theta [D] f32,
// out [B] f32 — all contiguous on the current device. B >= 1.
extern "C" int gather_margin_launch(const void* idx, const void* val,
                                    const void* off, const void* theta,
                                    void* out, long long B, long long K,
                                    long long D, void* stream) {
  const long long blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  gather_margin_kernel<<<static_cast<unsigned int>(blocks),
                         kWarp * kRowsPerBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(off), static_cast<const float*>(theta),
      static_cast<float*>(out), B, K, D);
  return static_cast<int>(cudaGetLastError());
}
