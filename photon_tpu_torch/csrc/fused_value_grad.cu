// Fused GLM value + gradient in one pass over the features: K1 (dense
// rows) and K2 (padded-ELL rows).
//
//   value = sum_i w_i * l(z_i, y_i),   grad = sum_i w_i * l'(z_i, y_i) * x_i,
//   z_i = x_i . coef + off_i
//
// Replaces the TPU kernels photon_tpu/ops/pallas_glm.py::_fused (wrapper
// fused_dense_value_grad, K1) and ::_fused_sparse (wrapper
// fused_sparse_value_grad, K2). There the grid runs in order on one core
// and every step adds into one revisited output block. Thread blocks on
// Hopper run at the same time and in no order, so here:
//
//   * a grid of a FIXED number of blocks (kGridBlocks, two per SM of the
//     H100's 132) takes the rows in a fixed assignment; each block writes
//     its own partial (value, grad[D]);
//   * a second launch sums the partials, for each column in block order.
//   No float atomics anywhere, so a rerun on the same inputs is bitwise
//   equal.
//
// K1, two forms chosen by the width:
//   * rows in registers (D <= 8192 and a multiple of one 16-byte vector):
//     a group of 1, 2, 4 or 8 warps takes whole rows, lane l of the group
//     holding the 16-byte pieces l, l+32g, ... of the row and of coef in
//     registers (up to 32 values a lane). It forms the margin (a
//     fixed-order butterfly in each warp, then the group's warps in warp
//     order, so every lane holds the same sum), evaluates the loss (a
//     switch over the four losses) and adds r_i * x_i into its own register
//     copy of the gradient. X is read from device memory exactly once and
//     never re-read; at the end the groups' gradients are summed in group
//     order.
//   * tiles (any other D, no limit): per 32-row tile, one warp per row for
//     the margins, then threads owning fixed columns add r_i * X[i, c]
//     over the tile's rows in order, re-reading the tile from L1/L2.
//   Bound on this card: bytes. Per call it must read X once (n*D*4, or
//   n*D*2 for bf16), y/off/w (n*12) and coef (D*4), and write grad (D*4),
//   against 4*n*D flops.
//
// K2: coef (D <= 4096) and one [D] gradient accumulator per warp in
// shared memory. Each warp takes runs of 8 consecutive ELL rows and starts
// all their loads before using any: lanes over the K slots gather coef,
// a butterfly gives every lane each margin, lane q evaluates row q's loss.
// Then, row by row in order, for the gradient, the lanes holding the same
// column (__match_any_sync) hand their terms to the lowest of them, which
// adds them to the warp's accumulator in lane order; so each column's sum
// runs in a fixed order, duplicate ids in a row accumulate, and no two
// warps ever touch one accumulator. An index outside [0, D) adds 0 (the
// one-hot semantics of the Pallas kernel), so pad slots (0, 0.0) are
// inert. The block sums its warps' accumulators in warp order.
//   Bound: bytes, n*K*8 (idx + val) + n*12 + D*8.
//
// bf16 storage is read as __nv_bfloat16 and accumulated in f32. Rows
// beyond n contribute nothing; null off / w mean 0 / 1.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each
// launcher returns cudaGetLastError() so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTileRows = 32;
constexpr int kGridBlocks = 264;
// values of a row each lane holds when K1 keeps rows in registers
constexpr int kRowFloats = 32;
constexpr int kSparseRows = 8;  // ELL rows a warp has in flight
// floats: 48,000 bytes, under the 48 KB a block may take without opting
// in, with room for the kernel's static shared arrays
constexpr long long kSmemAccMax = 12000;
constexpr long long kSparseMaxDim = 4096;

enum LossId { kLogistic = 0, kSquared = 1, kPoisson = 2, kSmoothedHinge = 3 };

__device__ __forceinline__ void loss_and_dz(int loss, float z, float y,
                                            float* l, float* dz) {
  switch (loss) {
    case kLogistic:
      // log(1 + e^z) as logaddexp(0, z) = max(z, 0) + log1p(e^-|z|),
      // finite for any finite z; sigmoid as 1 / (1 + e^-z)
      *l = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z))) - y * z;
      *dz = 1.0f / (1.0f + expf(-z)) - y;
      break;
    case kSquared: {
      const float r = z - y;
      *l = 0.5f * r * r;
      *dz = r;
      break;
    }
    case kPoisson: {
      const float ez = expf(z);
      *l = ez - y * z;
      *dz = ez - y;
      break;
    }
    default: {  // kSmoothedHinge, labels {0, 1} -> s = {-1, +1}
      const float s = 2.0f * y - 1.0f;
      const float t = s * z;
      float lt = 0.0f, dt = 0.0f;
      if (t <= 0.0f) {
        lt = 0.5f - t;
        dt = -1.0f;
      } else if (t < 1.0f) {
        const float u = 1.0f - t;
        lt = 0.5f * u * u;
        dt = t - 1.0f;
      }
      *l = lt;
      *dz = s * dt;
      break;
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 16 bytes of storage -> floats
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      o[2 * k] = f.x;
      o[2 * k + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    v += __shfl_down_sync(0xffffffffu, v, s);
  }
  return v;
}

// a sum over the warp in a fixed order that leaves the same bits in every
// lane (IEEE addition commutes, so both partners of each exchange agree)
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    v += __shfl_xor_sync(0xffffffffu, v, s);
  }
  return v;
}

// one row's label, offset and weight, loaded together with its features
// so the loss never waits on a second trip to memory
struct RowIn {
  float y, off, w;
};

__device__ __forceinline__ RowIn load_row_in(int64_t row,
                                             const float* __restrict__ y,
                                             const float* __restrict__ off,
                                             const float* __restrict__ w) {
  return {y[row], off != nullptr ? off[row] : 0.0f,
          w != nullptr ? w[row] : 1.0f};
}

// r = w * l'(z), lw = w * l(z) for one row of margin m
__device__ __forceinline__ void row_terms(int loss, float m, const RowIn& in,
                                          float* r, float* lw) {
  float l, dz;
  loss_and_dz(loss, m + in.off, in.y, &l, &dz);
  *lw = in.w * l;
  *r = in.w * dz;
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_tiles_kernel(int loss, const T* __restrict__ X,
                      const float* __restrict__ y,
                      const float* __restrict__ off,
                      const float* __restrict__ w,
                      const float* __restrict__ coef,
                      float* __restrict__ part_val,
                      float* __restrict__ part_grad, int64_t n, int64_t D,
                      int smem_acc) {
  extern __shared__ float dyn_smem[];
  __shared__ float r_s[kTileRows];
  __shared__ float lw_s[kTileRows];
  constexpr int N = kVec ? Vec16<T>::N : 1;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  float* acc = smem_acc ? dyn_smem
                        : part_grad + static_cast<int64_t>(blockIdx.x) * D;
  // each thread owns columns c = tid*N + k*kThreads*N .. +N-1, in every
  // loop below, so acc needs no synchronisation
  for (int64_t c = static_cast<int64_t>(tid) * N; c < D;
       c += static_cast<int64_t>(kThreads) * N) {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[c + k] = 0.0f;
  }
  float block_val = 0.0f;  // thread 0's running sum
  const int64_t tiles = (n + kTileRows - 1) / kTileRows;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t row0 = t * kTileRows;
    for (int i = warp; i < kTileRows; i += kWarps) {
      const int64_t row = row0 + i;
      float r = 0.0f, lw = 0.0f;
      if (row < n) {  // uniform across the warp
        const RowIn in = load_row_in(row, y, off, w);
        const T* xr = X + row * D;
        float m = 0.0f;
        for (int64_t c = static_cast<int64_t>(lane) * N; c < D;
             c += static_cast<int64_t>(kWarp) * N) {
          if constexpr (kVec) {
            float xv[N];
            Vec16<T>::load(xr + c, xv);
#pragma unroll
            for (int k = 0; k < N; ++k) m = fmaf(xv[k], __ldg(coef + c + k), m);
          } else {
            m = fmaf(to_f(xr[c]), __ldg(coef + c), m);
          }
        }
        m = warp_sum(m);
        if (lane == 0) row_terms(loss, m, in, &r, &lw);
      }
      if (lane == 0) {
        r_s[i] = r;
        lw_s[i] = lw;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < kTileRows; ++i) block_val += lw_s[i];
    }
    const int rows = static_cast<int>(
        n - row0 < kTileRows ? n - row0 : kTileRows);
    for (int64_t c = static_cast<int64_t>(tid) * N; c < D;
         c += static_cast<int64_t>(kThreads) * N) {
      float g[N];
#pragma unroll
      for (int k = 0; k < N; ++k) g[k] = acc[c + k];
      const T* xc = X + row0 * D + c;
      for (int i = 0; i < rows; ++i) {
        const float ri = r_s[i];
        if constexpr (kVec) {
          float xv[N];
          Vec16<T>::load(xc + static_cast<int64_t>(i) * D, xv);
#pragma unroll
          for (int k = 0; k < N; ++k) g[k] = fmaf(ri, xv[k], g[k]);
        } else {
          g[0] = fmaf(ri, to_f(xc[static_cast<int64_t>(i) * D]), g[0]);
        }
      }
#pragma unroll
      for (int k = 0; k < N; ++k) acc[c + k] = g[k];
    }
    __syncthreads();
  }
  if (smem_acc) {
    float* out = part_grad + static_cast<int64_t>(blockIdx.x) * D;
    for (int64_t c = static_cast<int64_t>(tid) * N; c < D;
         c += static_cast<int64_t>(kThreads) * N) {
#pragma unroll
      for (int k = 0; k < N; ++k) out[c + k] = acc[c + k];
    }
  }
  if (tid == 0) part_val[blockIdx.x] = block_val;
}

// K1 with each row in registers: a group of kGroup warps takes one row,
// each lane holding kChunks 16-byte pieces of it, so a group covers up to
// kChunks * kGroup * 32 * N columns and a block has kWarps / kGroup rows
// in flight. A group of more than one warp adds its warps' margin sums
// through shared memory, in warp order, so every warp of it holds the
// same margin.
template <typename T, int kChunks, int kGroup>
__global__ void __launch_bounds__(kThreads, 2)
dense_rows_kernel(int loss, const T* __restrict__ X,
                  const float* __restrict__ y,
                  const float* __restrict__ off,
                  const float* __restrict__ w,
                  const float* __restrict__ coef,
                  float* __restrict__ part_val,
                  float* __restrict__ part_grad, int64_t n, int D) {
  constexpr int N = Vec16<T>::N;
  constexpr int kGroups = kWarps / kGroup;  // rows a block has in flight
  // columns one piece of every lane of a group covers
  constexpr int kSpan = kGroup * kWarp * N;
  __shared__ float acc_s[kChunks * kSpan];
  __shared__ float val_s[kGroups];
  // the warps' margin sums, two buffers used in turn so that one barrier
  // a row suffices
  __shared__ float msum_s[2][kWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int group = warp / kGroup;
  const int col0 = ((warp % kGroup) * kWarp + lane) * N;
  float cf[kChunks][N];
  float g[kChunks][N];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = k * kSpan + col0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      cf[k][j] = c < D ? __ldg(coef + c + j) : 0.0f;
      g[k][j] = 0.0f;
    }
  }
  float vacc = 0.0f;
  int buf = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kGroups;
  // with groups of several warps the loop runs the same number of times
  // in every warp of the block (its first row, row - group, is the same),
  // as the barrier inside needs
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kGroups + group;
       kGroup > 1 ? row - group < n : row < n; row += stride) {
    const bool live = kGroup == 1 || row < n;  // uniform across the group
    RowIn in{0.0f, 0.0f, 0.0f};
    if (live) in = load_row_in(row, y, off, w);
    const T* xr = X + row * D;
    float xv[kChunks][N];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = k * kSpan + col0;
      if (live && c < D) {
        Vec16<T>::load(xr + c, xv[k]);
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) xv[k][j] = 0.0f;
      }
    }
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaf(xv[k][j], cf[k][j], m);
    }
    m = warp_allsum(m);
    if constexpr (kGroup > 1) {
      if (lane == 0) msum_s[buf][warp] = m;
      __syncthreads();
      m = 0.0f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) m += msum_s[buf][group * kGroup + k];
      buf ^= 1;
    }
    if (live) {
      float r, lw;
      row_terms(loss, m, in, &r, &lw);
      vacc += lw;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
#pragma unroll
        for (int j = 0; j < N; ++j) g[k][j] = fmaf(r, xv[k][j], g[k][j]);
      }
    }
  }
  // the block's gradient: the groups' copies summed in group order
  for (int gr = 0; gr < kGroups; ++gr) {
    if (group == gr) {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = k * kSpan + col0;
        if (c < D) {
#pragma unroll
          for (int j = 0; j < N; ++j) {
            acc_s[c + j] = gr == 0 ? g[k][j] : acc_s[c + j] + g[k][j];
          }
        }
      }
    }
    __syncthreads();
  }
  // every warp of a group holds the group's value sum; its first one
  // reports it
  if (lane == 0 && warp % kGroup == 0) val_s[group] = vacc;
  __syncthreads();
  float* out = part_grad + static_cast<int64_t>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kThreads) out[c] = acc_s[c];
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int k = 0; k < kGroups; ++k) v += val_s[k];
    part_val[blockIdx.x] = v;
  }
}

// one 32-slot piece of an ELL row's gradient terms (column c, term v per
// lane; c outside [0, D) for none): lanes holding the same column hand
// their terms to the lowest of them, which adds them in lane order
__device__ __forceinline__ void ell_scatter(int c, float v, int D,
                                            float* acc, float* contrib,
                                            int lane) {
  const bool valid = c >= 0 && c < D;
  contrib[lane] = v;
  __syncwarp();
  const unsigned group = __match_any_sync(
      0xffffffffu, valid ? static_cast<unsigned>(c) : 0xffffffffu);
  if (valid && lane == __ffs(group) - 1) {
    float s = acc[c];
    for (unsigned m = group; m != 0; m &= m - 1) s += contrib[__ffs(m) - 1];
    acc[c] = s;
  }
  __syncwarp();
}

template <typename T, int kW>
__global__ void __launch_bounds__(kW * kWarp)
sparse_rows_kernel(int loss, const int32_t* __restrict__ idx,
                   const T* __restrict__ val, const float* __restrict__ y,
                   const float* __restrict__ off,
                   const float* __restrict__ w,
                   const float* __restrict__ coef,
                   float* __restrict__ part_val,
                   float* __restrict__ part_grad, int64_t n, int K, int D) {
  extern __shared__ float dyn_smem[];
  float* coef_s = dyn_smem;  // [D], then kW accumulators of [D]
  __shared__ float contrib_s[kW][kWarp];
  __shared__ float val_s[kW];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int c = threadIdx.x; c < D; c += kW * kWarp) coef_s[c] = coef[c];
  for (int c = threadIdx.x; c < kW * D; c += kW * kWarp) {
    dyn_smem[D + c] = 0.0f;
  }
  __syncthreads();
  float* acc = dyn_smem + D * (1 + warp);
  float* contrib = contrib_s[warp];
  float vacc = 0.0f;
  // each warp takes runs of kSparseRows consecutive rows, runs striding
  // over the grid; a run's loads all start before any is used
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kW * kSparseRows;
  for (int64_t r0 =
           (static_cast<int64_t>(blockIdx.x) * kW + warp) * kSparseRows;
       r0 < n; r0 += stride) {
    const int rows = static_cast<int>(
        n - r0 < kSparseRows ? n - r0 : kSparseRows);
    RowIn in{0.0f, 0.0f, 0.0f};  // lane q: row q's
    if (lane < rows) in = load_row_in(r0 + lane, y, off, w);
    float m[kSparseRows];
    int c[kSparseRows];
    float v[kSparseRows];
#pragma unroll
    for (int q = 0; q < kSparseRows; ++q) {
      m[q] = 0.0f;
      c[q] = -1;  // an ELL of width 0 has no piece at all
      v[q] = 0.0f;
    }
    for (int j0 = 0; j0 < K; j0 += kWarp) {
      const int j = j0 + lane;
#pragma unroll
      for (int q = 0; q < kSparseRows; ++q) {
        c[q] = -1;
        v[q] = 0.0f;
        if (q < rows && j < K) {
          c[q] = idx[(r0 + q) * K + j];
          v[q] = to_f(val[(r0 + q) * K + j]);
        }
      }
#pragma unroll
      for (int q = 0; q < kSparseRows; ++q) {
        if (c[q] >= 0 && c[q] < D) m[q] = fmaf(v[q], coef_s[c[q]], m[q]);
      }
    }
    // lane q evaluates row q's loss; every lane holds every margin
    float mine = 0.0f;
#pragma unroll
    for (int q = 0; q < kSparseRows; ++q) {
      m[q] = warp_allsum(m[q]);
      if (lane == q) mine = m[q];
    }
    float r_l = 0.0f, lw_l = 0.0f;
    if (lane < rows) row_terms(loss, mine, in, &r_l, &lw_l);
#pragma unroll
    for (int q = 0; q < kSparseRows; ++q) {
      const float r = __shfl_sync(0xffffffffu, r_l, q);
      vacc += __shfl_sync(0xffffffffu, lw_l, q);  // row order; 0 past n
      if (q < rows) {
        if (K <= kWarp) {  // the row's one piece is still in registers
          ell_scatter(c[q], v[q] * r, D, acc, contrib, lane);
        } else {
          for (int j0 = 0; j0 < K; j0 += kWarp) {
            const int j = j0 + lane;
            const int64_t e = (r0 + q) * K + j;
            ell_scatter(j < K ? idx[e] : -1,
                        j < K ? to_f(val[e]) * r : 0.0f, D, acc, contrib,
                        lane);
          }
        }
      }
    }
  }
  if (lane == 0) val_s[warp] = vacc;
  __syncthreads();
  float* out = part_grad + static_cast<int64_t>(blockIdx.x) * D;
  for (int c = threadIdx.x; c < D; c += kW * kWarp) {
    float s = dyn_smem[D + c];
    for (int k = 1; k < kW; ++k) s += dyn_smem[D * (1 + k) + c];
    out[c] = s;
  }
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int k = 0; k < kW; ++k) v += val_s[k];
    part_val[blockIdx.x] = v;
  }
}

// value = sum_b part_val[b], grad[c] = sum_b part_grad[b, c], each in a
// fixed order: 8 warps of a block take 8 consecutive runs of b for the
// same 32 columns, then the runs are added in order
constexpr int kRedSegs = kWarps;
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ part_val,
                       const float* __restrict__ part_grad, int G,
                       int64_t D, float* __restrict__ value,
                       float* __restrict__ grad) {
  __shared__ float seg_s[kRedSegs][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int seg = threadIdx.x / kWarp;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarp + lane;
  const int per = (G + kRedSegs - 1) / kRedSegs;
  const int b0 = seg * per;
  const int b1 = b0 + per < G ? b0 + per : G;
  float s = 0.0f;
  if (c < D) {
    for (int b = b0; b < b1; ++b) s += part_grad[static_cast<int64_t>(b) * D + c];
  }
  seg_s[seg][lane] = s;
  __syncthreads();
  if (seg == 0 && c < D) {
    float t = seg_s[0][lane];
    for (int k = 1; k < kRedSegs; ++k) t += seg_s[k][lane];
    grad[c] = t;
  }
  if (blockIdx.x == 0 && seg == 1) {
    float v = 0.0f;
    for (int b = lane; b < G; b += kWarp) v += part_val[b];
    v = warp_sum(v);
    if (lane == 0) *value = v;
  }
}

int grid_blocks(long long n) {
  const long long tiles = (n + kTileRows - 1) / kTileRows;
  return static_cast<int>(tiles < kGridBlocks ? tiles : kGridBlocks);
}

int reduce(const float* part_val, const float* part_grad, int G, long long D,
           void* value, void* grad, cudaStream_t s) {
  const long long blocks = D > 0 ? (D + kWarp - 1) / kWarp : 1;
  reduce_partials_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           s>>>(part_val, part_grad, G, D,
                                static_cast<float*>(value),
                                static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

struct DenseArgs {
  int loss;
  const void* X;
  const float* y;
  const float* off;
  const float* w;
  const float* coef;
  float* part_val;
  float* part_grad;
  int G;
  long long n;
  long long D;
  cudaStream_t s;
};

template <typename T, bool kVec>
int launch_tiles(const DenseArgs& a) {
  const int smem_acc = a.D <= kSmemAccMax ? 1 : 0;
  const size_t smem = smem_acc ? static_cast<size_t>(a.D) * sizeof(float) : 0;
  dense_tiles_kernel<T, kVec><<<a.G, kThreads, smem, a.s>>>(
      a.loss, static_cast<const T*>(a.X), a.y, a.off, a.w, a.coef,
      a.part_val, a.part_grad, a.n, a.D, smem_acc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kChunks, int kGroup = 1>
int launch_rows(const DenseArgs& a) {
  dense_rows_kernel<T, kChunks, kGroup><<<a.G, kThreads, 0, a.s>>>(
      a.loss, static_cast<const T*>(a.X), a.y, a.off, a.w, a.coef,
      a.part_val, a.part_grad, a.n, static_cast<int>(a.D));
  return static_cast<int>(cudaGetLastError());
}

// the smallest power-of-two load per lane-column (16-byte pieces a lane
// holds times warps a row) covering D, or 0 where a row needs more than
// every lane of a block holding kRowFloats values of it
int row_load(long long D, int n_per_piece) {
  for (int k = 1; k * n_per_piece <= kRowFloats * kWarps; k *= 2) {
    if (D <= static_cast<long long>(k) * kWarp * n_per_piece) return k;
  }
  return 0;
}

// a load of kLoad: up to kRowFloats / N pieces a lane, then more warps
template <typename T, int kLoad>
int launch_rows_load(const DenseArgs& a) {
  constexpr int P = kRowFloats / Vec16<T>::N;
  if constexpr (kLoad <= P) {
    return launch_rows<T, kLoad, 1>(a);
  } else {
    return launch_rows<T, P, kLoad / P>(a);
  }
}

template <typename T>
int launch_dense(const DenseArgs& a) {
  constexpr int N = Vec16<T>::N;
  // 16-byte vector loads need every row to start on a 16-byte boundary
  const bool vec = (reinterpret_cast<uintptr_t>(a.X) % 16) == 0 &&
                   a.D % N == 0;
  switch (vec ? row_load(a.D, N) : 0) {
    case 1: return launch_rows_load<T, 1>(a);
    case 2: return launch_rows_load<T, 2>(a);
    case 4: return launch_rows_load<T, 4>(a);
    case 8: return launch_rows_load<T, 8>(a);
    case 16: return launch_rows_load<T, 16>(a);
    case 32: return launch_rows_load<T, 32>(a);
    case 64:
      if constexpr (N == 4) return launch_rows_load<T, 64>(a);
      [[fallthrough]];
    default:
      return vec ? launch_tiles<T, true>(a) : launch_tiles<T, false>(a);
  }
}

template <typename T, int kW>
int launch_sparse(int loss, const void* idx, const void* val, const void* y,
                  const void* off, const void* w, const void* coef,
                  float* part_val, float* part_grad, int G, long long n,
                  long long K, long long D, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(1 + kW) * D * sizeof(float);
  static bool opted_in = false;  // dynamic shared memory past 48 KB
  if (!opted_in) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        sparse_rows_kernel<T, kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((1 + kW) * kSparseMaxDim * sizeof(float))));
    if (err != 0) return err;
    opted_in = true;
  }
  sparse_rows_kernel<T, kW><<<G, kW * kWarp, smem, s>>>(
      loss, static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<const float*>(y), static_cast<const float*>(off),
      static_cast<const float*>(w), static_cast<const float*>(coef),
      part_val, part_grad, n, static_cast<int>(K), static_cast<int>(D));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the launchers need for n rows and D columns:
// G partial values then G partial gradients [G, D].
extern "C" long long fused_value_grad_scratch_floats(long long n,
                                                     long long D) {
  const long long G = grid_blocks(n);
  return G + G * D;
}

// X [n, D] f32 (bf16 = 0) or bf16 (bf16 = 1); y [n] f32; off, w [n] f32
// or null; coef [D] f32; scratch as sized above; value [1] and grad [D]
// f32 out. All contiguous on the current device; n >= 1.
extern "C" int fused_dense_value_grad_launch(
    int loss, int bf16, const void* X, const void* y, const void* off,
    const void* w, const void* coef, void* scratch, void* value, void* grad,
    long long n, long long D, void* stream) {
  const int G = grid_blocks(n);
  float* part_val = static_cast<float*>(scratch);
  DenseArgs a{loss, X, static_cast<const float*>(y),
              static_cast<const float*>(off), static_cast<const float*>(w),
              static_cast<const float*>(coef), part_val, part_val + G, G, n,
              D, static_cast<cudaStream_t>(stream)};
  const int err = bf16 ? launch_dense<__nv_bfloat16>(a)
                       : launch_dense<float>(a);
  if (err != 0) return err;
  return reduce(a.part_val, a.part_grad, G, D, value, grad, a.s);
}

// idx [n, K] int32; val [n, K] f32 or bf16; y/off/w as above; coef [D]
// f32 with D <= 4096; K < 2^24. n >= 1.
extern "C" int fused_sparse_value_grad_launch(
    int loss, int bf16, const void* idx, const void* val, const void* y,
    const void* off, const void* w, const void* coef, void* scratch,
    void* value, void* grad, long long n, long long K, long long D,
    void* stream) {
  if (D < 0 || D > kSparseMaxDim || K < 0 || K > (1 << 24)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = grid_blocks(n);
  float* part_val = static_cast<float*>(scratch);
  float* part_grad = part_val + G;
  // eight warps a block where their accumulators leave room for two
  // blocks an SM, else four
  const bool wide = D > 2048;
  int err;
  if (bf16) {
    err = wide ? launch_sparse<__nv_bfloat16, 4>(loss, idx, val, y, off, w,
                                                 coef, part_val, part_grad, G,
                                                 n, K, D, s)
               : launch_sparse<__nv_bfloat16, 8>(loss, idx, val, y, off, w,
                                                 coef, part_val, part_grad, G,
                                                 n, K, D, s);
  } else {
    err = wide ? launch_sparse<float, 4>(loss, idx, val, y, off, w, coef,
                                         part_val, part_grad, G, n, K, D, s)
               : launch_sparse<float, 8>(loss, idx, val, y, off, w, coef,
                                         part_val, part_grad, G, n, K, D, s);
  }
  if (err != 0) return err;
  return reduce(part_val, part_grad, G, D, value, grad, s);
}
