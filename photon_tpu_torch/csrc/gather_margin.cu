// The GLMix serving margin, fixed term and every random-effect term in one
// launch. For each row b of a bucket of B rows:
//
//   out[b] = off[b] + sum_j val[b,j] * theta[idx[b,j]]              (fixed)
//          + sum_c sum_k sval_c[b,k] * T_c[ent_c[b], sidx_c[b,k]]  (random)
//
// Replaces the TPU kernel photon_tpu/ops/pallas_glm.py::_fused_margin
// (wrapper fused_gather_margin), which computes the fixed term; the JAX
// scorer (photon_tpu/serving/scorer.py::build_scorer_fn) adds the random
// terms in the same XLA program. The Pallas kernel expands each 128-row
// tile into a dense one-hot [tile, D] block in VMEM and runs one MXU
// contraction against theta; that expansion is a TPU device and is not
// carried over. Here:
//
//   * one warp per row, 8 rows per 256-thread block;
//   * lanes stride over a row's slots, so each warp's idx/val (and
//     sidx/sval) loads are coalesced; theta and the tables are read
//     through the read-only data cache (__ldg);
//   * a coordinate's slots T_c[ent, 0:K_c] are one contiguous table row,
//     so a warp's table reads are one or two transactions a row;
//   * out-of-range values add 0: an idx outside [0, D) (the Pallas
//     semantics, where it matches no one-hot column), an ent outside
//     [0, E_c] (row E_c is the explicit zero row) and an sidx outside
//     [0, K_c). The JAX scorer differs on the last two, which its own
//     assembler never emits: a negative ent wraps (jnp indexing) and an
//     sidx past K_c gathers NaN (take_along_axis);
//   * each lane accumulates in a fixed order and a fixed warp-shuffle
//     tree sums the lanes; the terms are added in the reference's order,
//     (fixed + off), then each coordinate's sum in coordinate order. No
//     atomics and no cross-block reduction, so reruns are bitwise equal.
//     With no coordinates the launch takes the kernel's fixed-only
//     instance, the PR 2 fixed-effect kernel as it was.
//
// Inputs of the serving path arrive as ONE staged buffer of 4-byte words
// (layout below), copied from pinned host memory by the launcher itself,
// and the [B] result is copied back by the same call, so a batch costs one
// C call: one copy in, one launch, one copy out. Layout for B rows, K
// fixed slots, coordinates c = 0..C-1 with K_c slots each:
//
//   idx [B, K] int32 | val [B, K] f32 | off [B] f32 |
//   per c: ent_c [B] int32 | sidx_c [B, K_c] int32 | sval_c [B, K_c] f32
//
// Coordinate c is described by 6 int64 (built once at model load):
// table pointer, table rows E_c + 1, K_c, and the word offsets of ent_c,
// sidx_c and sval_c divided by B (the layout scales with B, so one
// descriptor serves every bucket).
//
// Bound on this card: bytes. A call must move B*K*8 (idx, val) + B*8
// (off in, out) + sum_c B*(4 + K_c*8 + K_c*4) (ent, sidx and sval, and
// at most K_c table values a row) + D*4 (theta) bytes, against
// 2*B*(K + sum_c K_c) flops. At the serving bucket (B = 64: 141 KB,
// 0.00004 ms at 3.35 TB/s) the launch, not the bytes, sets the floor.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each
// launcher returns the first CUDA error of its calls, so a refused copy
// or launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kDescWords = 6;

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, s);
  }
  return acc;  // the row's sum in lane 0
}

// kRandom false: the fixed term alone (no coordinates), the PR 2 kernel
// as it was; true: the fixed term, then every coordinate.
template <bool kRandom>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
glmix_margin_kernel(const int32_t* __restrict__ idx,
                    const float* __restrict__ val,
                    const float* __restrict__ off,
                    const float* __restrict__ theta,
                    const int32_t* __restrict__ layout,
                    const long long* __restrict__ desc, int n_coords,
                    float* __restrict__ out,
                    int64_t B, int64_t K, int64_t D) {
  const int lane = threadIdx.x % kWarp;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kWarp;
  // the whole warp shares one row, so it leaves together and the full
  // shuffle masks below stay valid
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
  const float fixed = warp_sum(acc);
  if constexpr (!kRandom) {
    if (lane == 0) out[row] = fixed + (off != nullptr ? off[row] : 0.0f);
    return;
  }
  float total = fixed + (off != nullptr ? off[row] : 0.0f);
  for (int c = 0; c < n_coords; ++c) {
    const long long* dc = desc + c * kDescWords;
    const float* table = reinterpret_cast<const float*>(__ldg(dc));
    const int64_t rows = __ldg(dc + 1);
    const int64_t kc = __ldg(dc + 2);
    const int32_t e = __ldg(layout + B * __ldg(dc + 3) + row);
    const int32_t* rs = layout + B * __ldg(dc + 4) + row * kc;
    const float* rsv =
        reinterpret_cast<const float*>(layout + B * __ldg(dc + 5)) + row * kc;
    acc = 0.0f;
    // e is the same for the whole warp, so the branch is warp-uniform
    if (e >= 0 && static_cast<int64_t>(e) < rows) {
      const float* trow = table + static_cast<int64_t>(e) * kc;
      for (int64_t k = lane; k < kc; k += kWarp) {
        const int32_t s = __ldg(rs + k);
        const float v = __ldg(rsv + k);
        if (s >= 0 && static_cast<int64_t>(s) < kc) {
          acc = fmaf(v, __ldg(trow + s), acc);
        }
      }
    }
    total += warp_sum(acc);
  }
  if (lane == 0) out[row] = total;
}

}  // namespace

// One batch: copy in_bytes from host_in (pinned) to dev_in, launch the
// kernel, copy out [B] f32 to host_out (pinned), all on `stream`, none
// waited for. host_in / host_out may be null (no copy): the fixed-effect
// wrapper passes separate idx [B, K] int32, val [B, K] f32, off [B] f32
// or null, and no coordinates. theta [D] f32; layout is the staged
// device buffer the coordinates' offsets refer to; desc [n_coords, 6]
// int64 on the device. B >= 1.
extern "C" int glmix_margin_launch(const void* host_in, void* dev_in,
                                   long long in_bytes, const void* idx,
                                   const void* val, const void* off,
                                   const void* theta, const void* desc,
                                   int n_coords, void* out, void* host_out,
                                   long long B, long long K, long long D,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (host_in != nullptr && in_bytes > 0) {
    err = cudaMemcpyAsync(dev_in, host_in, static_cast<size_t>(in_bytes),
                          cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = n_coords > 0 ? glmix_margin_kernel<true>
                             : glmix_margin_kernel<false>;
  kernel<<<static_cast<unsigned int>((B + kRowsPerBlock - 1) / kRowsPerBlock),
           kWarp * kRowsPerBlock, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(off), static_cast<const float*>(theta),
      static_cast<const int32_t*>(dev_in),
      static_cast<const long long*>(desc), n_coords,
      static_cast<float*>(out), B, K, D);
  err = cudaGetLastError();
  if (err != cudaSuccess || host_out == nullptr) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyAsync(
      host_out, out, static_cast<size_t>(B) * sizeof(float),
      cudaMemcpyDeviceToHost, s));
}
