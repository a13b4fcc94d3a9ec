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
//     H100's 132) takes the rows in a fixed assignment; each block (K1's
//     cluster form: each cluster) writes its own partial (value, grad[D]);
//   * a second launch sums the partials, for each column in block order.
//   No atomic operation anywhere, so a rerun on the same inputs is bitwise
//   equal.
//
// K1 keeps each row on chip between its margin and its gradient, so X is
// read from device memory exactly once, at every width up to 65,536:
//   * rows in registers (D <= 8192): a group of 1, 2, 4 or 8 warps takes
//     whole rows, lane l of the group holding the pieces l, l+32g, ... of
//     the row and of coef in registers (up to 32 values a lane). A piece
//     is one 16-byte vector where every row starts on a 16-byte boundary
//     (D a multiple of 4 f32 or 8 bf16, X aligned), else one element
//     (rows of D = 257, 1025, ...: an intercept column; a warp still reads
//     32 neighbouring elements). The group forms the margin (a fixed-order
//     butterfly in each warp, then the group's warps in warp order, so
//     every lane holds the same sum), evaluates the loss (a switch over the
//     four losses) and adds r_i * x_i into its own register copy of the
//     gradient; at the end the groups' gradients are summed in group order.
//   * a cluster of 2, 4 or 8 blocks a row (8192 < D <= 65,536): each block
//     holds its slice of the row in registers as a group of 8 warps does;
//     the blocks' warp sums go through distributed shared memory and are
//     added in (block rank, warp) order, so every block holds the same
//     margin bits. One cluster barrier a row, with two margin buffers used
//     in turn. Each block adds r_i * x_i into its own slice of the
//     gradient; the cluster writes one partial.
//   * tiles (D > 65,536, no limit): per 32-row tile, one warp per row for
//     the margins, then threads owning fixed columns add r_i * X[i, c]
//     over the tile's rows in order, re-reading the tile from L1/L2.
//   Bound on this card: bytes. Per call it must read X once (n*D*4, or
//   n*D*2 for bf16), y/off/w (n*12) and coef (D*4), and write grad (D*4),
//   against 4*n*D flops.
//
// K2: coef (D <= 4096) and one [D] gradient accumulator per warp in
// shared memory. Each warp takes runs of 8 consecutive ELL rows, and the
// next run's loads start before the work on this one. Lanes over the K
// slots gather coef, a butterfly gives every lane each margin, lane q
// evaluates row q's loss. For the gradient, the lanes holding the same
// column of a row hand their terms to the lowest of them, which adds them
// to the warp's accumulator in lane order, the run's rows in order; so
// each column's sum runs in a fixed order, duplicate ids in a row
// accumulate, and no two warps ever touch one accumulator. The lanes of
// one column are found through a tag byte a column (each lane writes its
// id there and reads back the winner), in one pass for all the run's
// rows before any accumulator is touched. An index outside [0, D) adds 0
// (the one-hot semantics of the Pallas kernel), so pad slots (0, 0.0) are
// inert. The block sums its warps' accumulators in warp order.
//   Bound: bytes, n*K*8 (idx + val) + n*12 + D*8.
//
// bf16 storage is read as __nv_bfloat16 and accumulated in f32. Rows
// beyond n contribute nothing; null off / w mean 0 / 1.
//
// Plain C interface (no PyTorch headers), loaded with ctypes; each
// launcher returns the CUDA error of the launch (and of any attribute it
// sets), so a refused launch is reported.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kTileRows = 32;
constexpr int kGridBlocks = 264;
// values of a row each lane holds when K1 keeps rows in registers
constexpr int kRowFloats = 32;
// columns one block holds in registers: the widest row of one group
constexpr int kBlockCols = kRowFloats * kThreads;
// the largest portable cluster: clusters of 8 blocks cover D <= 65,536
constexpr int kMaxCluster = 8;
// floats: 48,000 bytes, under the 48 KB a block may take without opting
// in, with room for the kernel's static shared arrays
constexpr long long kSmemAccMax = 12000;
constexpr int kSparseRows = 8;  // ELL rows a warp has in a run
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    v += __shfl_down_sync(kFull, v, s);
  }
  return v;
}

// a sum over the warp in a fixed order that leaves the same bits in every
// lane (IEEE addition commutes, so both partners of each exchange agree)
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int s = kWarp / 2; s > 0; s /= 2) {
    v += __shfl_xor_sync(kFull, v, s);
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


// K1's row pieces: 16 bytes of storage -> floats (rows that start on a
// 16-byte boundary) ...
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
// ... or one element (any other row), loaded raw and converted only
// once every load of the row is in flight
template <typename T>
struct Elem1;
template <>
struct Elem1<float> {
  static constexpr int N = 1;
  using Raw = float;
  __device__ __forceinline__ static Raw load_raw(const float* p) {
    return *p;
  }
  __device__ __forceinline__ static float unpack(Raw v) { return v; }
};
template <>
struct Elem1<__nv_bfloat16> {
  static constexpr int N = 1;
  using Raw = unsigned short;
  __device__ __forceinline__ static Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ static float unpack(Raw v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
};

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

// K1 with each row on chip: a group of kGroup warps takes one row, each
// lane holding kChunks pieces (Ld: a 16-byte vector or one element) of
// it, so a group covers up to kChunks * kGroup * 32 * N columns and a
// block has kWarps / kGroup rows in flight. A group of more than one warp
// adds its warps' margin sums through shared memory, in warp order, so
// every warp of it holds the same margin. With kCluster > 1 a row is
// shared by the kCluster blocks of a cluster, block rank q holding the
// columns [q*S, (q+1)*S) as one group of every warp; the warp sums of all
// the blocks go through distributed shared memory.
template <typename T, typename Ld, int kChunks, int kGroup, int kCluster>
__global__ void __launch_bounds__(kThreads, 2)
dense_rows_kernel(int loss, const T* __restrict__ X,
                  const float* __restrict__ y,
                  const float* __restrict__ off,
                  const float* __restrict__ w,
                  const float* __restrict__ coef,
                  float* __restrict__ part_val,
                  float* __restrict__ part_grad, int64_t n, int D, int S) {
  static_assert(kCluster == 1 || kGroup == kWarps,
                "a cluster shares a row between whole blocks");
  constexpr int N = Ld::N;
  constexpr int kGroups = kWarps / kGroup;  // rows a block has in flight
  // columns one piece of every lane of a group covers
  constexpr int kSpan = kGroup * kWarp * N;
  __shared__ float acc_s[kCluster == 1 ? kChunks * kSpan : 1];
  __shared__ float val_s[kGroups];
  // the warps' margin sums, two buffers used in turn so that one barrier
  // a row suffices
  __shared__ float msum_s[2][kWarps];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int group = warp / kGroup;
  int rank = 0;
  if constexpr (kCluster > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
  }
  // this block's columns [lo, hi): the whole row, or its slice of it
  const int lo = rank * S;
  const int hi = lo + S < D ? lo + S : D;
  const int col0 = lo + ((warp % kGroup) * kWarp + lane) * N;
  float cf[kChunks][N];
  float g[kChunks][N];
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = k * kSpan + col0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      cf[k][j] = c < hi ? __ldg(coef + c + j) : 0.0f;
      g[k][j] = 0.0f;
    }
  }
  float vacc = 0.0f;
  int buf = 0;
  // a cluster is one unit of the row assignment: its blocks take the
  // same rows
  const int64_t unit = blockIdx.x / kCluster;
  const int64_t stride = static_cast<int64_t>(gridDim.x / kCluster) * kGroups;
  // with groups of several warps the loop runs the same number of times
  // in every warp of the block (its first row, row - group, is the same)
  // and of the cluster, as the barrier inside needs
  for (int64_t row = unit * kGroups + group;
       kGroup > 1 ? row - group < n : row < n; row += stride) {
    const bool live = kGroup == 1 || row < n;  // uniform across the group
    RowIn in{0.0f, 0.0f, 0.0f};
    if (live) in = load_row_in(row, y, off, w);
    const T* xr = X + row * D;
    float xv[kChunks][N];
    if constexpr (N == 1) {
      typename Ld::Raw raw[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = k * kSpan + col0;
        raw[k] = live && c < hi ? Ld::load_raw(xr + c)
                                : static_cast<typename Ld::Raw>(0);
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) xv[k][0] = Ld::unpack(raw[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int c = k * kSpan + col0;
        if (live && c < hi) {
          Ld::load(xr + c, xv[k]);
        } else {
#pragma unroll
          for (int j = 0; j < N; ++j) xv[k][j] = 0.0f;
        }
      }
    }
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
#pragma unroll
      for (int j = 0; j < N; ++j) m = fmaf(xv[k][j], cf[k][j], m);
    }
    m = warp_allsum(m);
    if constexpr (kCluster > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      if (lane == 0) msum_s[buf][warp] = m;
      cluster.sync();
      // every warp of every block adds the same values in the same order
      float v = 0.0f;
      for (int q = lane; q < kCluster * kWarps; q += kWarp) {
        v += cluster.map_shared_rank(&msum_s[buf][0], q / kWarps)[q % kWarps];
      }
      m = warp_allsum(v);
      buf ^= 1;
    } else if constexpr (kGroup > 1) {
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
  if constexpr (kCluster > 1) {
    // no block leaves while another may still read its margin buffers
    cg::this_cluster().sync();
    float* out = part_grad + unit * D;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int c = k * kSpan + col0;
      if (c < hi) {
#pragma unroll
        for (int j = 0; j < N; ++j) out[c + j] = g[k][j];
      }
    }
    // every block of the cluster holds the same value sum
    if (rank == 0 && threadIdx.x == 0) part_val[unit] = vacc;
  } else {
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
}

// K2. A run of kSparseRows ELL rows, the first 32-slot piece of each:
// lane j holds slot j of every row (column -1 past K or past n), lane q
// row q's label, offset and weight
struct EllRun {
  int c[kSparseRows];
  float v[kSparseRows];
  RowIn in;
};

template <typename T>
__device__ __forceinline__ void load_run(EllRun& p, int64_t r0, int64_t n,
                                         int K, int lane,
                                         const int32_t* __restrict__ idx,
                                         const T* __restrict__ val,
                                         const float* __restrict__ y,
                                         const float* __restrict__ off,
                                         const float* __restrict__ w) {
  p.in = RowIn{0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < kSparseRows; ++q) {
    p.c[q] = -1;  // an ELL of width 0 has no piece at all
    p.v[q] = 0.0f;
  }
  if (r0 >= n) return;
  const int rows = static_cast<int>(n - r0 < kSparseRows ? n - r0
                                                         : kSparseRows);
  if (lane < rows) p.in = load_row_in(r0 + lane, y, off, w);
#pragma unroll
  for (int q = 0; q < kSparseRows; ++q) {
    if (q < rows && lane < K) {
      p.c[q] = idx[(r0 + q) * K + lane];
      p.v[q] = to_f(val[(r0 + q) * K + lane]);
    }
  }
}

// the lanes whose 6-bit key equals this lane's, one ballot a bit
__device__ __forceinline__ unsigned peers_by_ballot(unsigned key) {
  unsigned m = kFull;
#pragma unroll
  for (int b = 0; b < 6; ++b) {
    const bool bit = (key >> b) & 1u;
    const unsigned bal = __ballot_sync(kFull, bit);
    m &= bit ? bal : ~bal;
  }
  return m;
}

// The lanes of the warp holding the same column c as this one (ok: this
// lane has a term to add). Each such lane writes its lane id into the
// column's tag byte and reads it back: lanes of one column read the same
// winner, and where every lane reads its own id no column is held twice.
__device__ __forceinline__ unsigned column_peers(int c, bool ok,
                                                 unsigned char* tag,
                                                 int lane) {
  if (ok) tag[c] = static_cast<unsigned char>(lane);
  __syncwarp();
  const int win = ok ? tag[c] : lane;
  __syncwarp();
  if (__ballot_sync(kFull, win != lane) == 0) return 1u << lane;
  return peers_by_ballot(ok ? win : kWarp);
}

// A term of +-0 is skipped: added to a sum that starts at +0 (and so is
// never -0) it changes no bit.
__device__ __forceinline__ bool adds(int c, float t, int D) {
  return c >= 0 && c < D && t != 0.0f;
}

// the leader (lowest lane) of a column's peers adds their terms to the
// accumulator in lane order
__device__ __forceinline__ void add_peers(int c, float t, unsigned peers,
                                          int D, float* acc,
                                          const float* contrib, int lane) {
  if (adds(c, t, D) && lane == __ffs(peers) - 1) {
    float s = acc[c] + t;
    for (unsigned b = peers & (peers - 1); b != 0; b &= b - 1) {
      s += contrib[__ffs(b) - 1];
    }
    acc[c] = s;
  }
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
  constexpr int R = kSparseRows;
  // [D] coef, then kW accumulators of [D], then kW tag bytes of [D]
  extern __shared__ float dyn_smem[];
  float* coef_s = dyn_smem;
  __shared__ float contrib_s[kW][R][kWarp];
  __shared__ float val_s[kW];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  for (int c = threadIdx.x; c < D; c += kW * kWarp) coef_s[c] = coef[c];
  for (int c = threadIdx.x; c < kW * D; c += kW * kWarp) {
    dyn_smem[D + c] = 0.0f;
  }
  __syncthreads();
  float* acc = dyn_smem + D * (1 + warp);
  unsigned char* tag =
      reinterpret_cast<unsigned char*>(dyn_smem + D * (1 + kW)) + warp * D;
  float vacc = 0.0f;
  // each warp takes runs of R consecutive rows, runs striding over the
  // grid; the next run's loads start before the work on this one
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kW * R;
  int64_t r0 = (static_cast<int64_t>(blockIdx.x) * kW + warp) * R;
  EllRun next;
  load_run(next, r0, n, K, lane, idx, val, y, off, w);
  for (; r0 < n; r0 += stride) {
    const int rows = static_cast<int>(n - r0 < R ? n - r0 : R);
    const EllRun cur = next;
    load_run(next, r0 + stride, n, K, lane, idx, val, y, off, w);
    float m[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m[q] = 0.0f;
      if (cur.c[q] >= 0 && cur.c[q] < D) {
        m[q] = fmaf(cur.v[q], coef_s[cur.c[q]], m[q]);
      }
    }
    // K > 32: the rows' further pieces, all loads of a piece first
    for (int j0 = kWarp; j0 < K; j0 += kWarp) {
      const int j = j0 + lane;
      int c[R];
      float v[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        c[q] = -1;
        v[q] = 0.0f;
        if (q < rows && j < K) {
          c[q] = idx[(r0 + q) * K + j];
          v[q] = to_f(val[(r0 + q) * K + j]);
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (c[q] >= 0 && c[q] < D) m[q] = fmaf(v[q], coef_s[c[q]], m[q]);
      }
    }
    // lane q evaluates row q's loss; every lane holds every margin
    float mine = 0.0f;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m[q] = warp_allsum(m[q]);
      if (lane == q) mine = m[q];
    }
    float r_l = 0.0f, lw_l = 0.0f;
    if (lane < rows) row_terms(loss, mine, cur.in, &r_l, &lw_l);
    if (K <= kWarp) {
      // The rows' one piece is still in registers. Every row's peers are
      // found first, so the only chain left is each column's
      // read-add-write, the rows in order.
      float t[R];
      unsigned grp[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        t[q] = cur.v[q] * __shfl_sync(kFull, r_l, q);
        vacc += __shfl_sync(kFull, lw_l, q);  // row order; 0 past n
        grp[q] = column_peers(cur.c[q], adds(cur.c[q], t[q], D), tag, lane);
        contrib_s[warp][q][lane] = t[q];
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < R; ++q) {
        add_peers(cur.c[q], t[q], grp[q], D, acc, contrib_s[warp][q], lane);
        __syncwarp();
      }
    } else {
      // rows in several pieces: each piece re-read and added in turn
      float* contrib = contrib_s[warp][0];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float r = __shfl_sync(kFull, r_l, q);
        vacc += __shfl_sync(kFull, lw_l, q);  // row order; 0 past n
        if (q < rows) {
          for (int j0 = 0; j0 < K; j0 += kWarp) {
            const int j = j0 + lane;
            const int64_t e = (r0 + q) * K + j;
            const int c = j < K ? idx[e] : -1;
            const float t = j < K ? to_f(val[e]) * r : 0.0f;
            const unsigned peers = column_peers(c, adds(c, t, D), tag, lane);
            contrib[lane] = t;
            __syncwarp();
            add_peers(c, t, peers, D, acc, contrib, lane);
            __syncwarp();
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
  int G;  // blocks the scratch holds partials for
  long long n;
  long long D;
  cudaStream_t s;
  int parts;  // partials the launch wrote (<= G)
};

template <typename T, bool kVec>
int launch_tiles(DenseArgs& a) {
  const int smem_acc = a.D <= kSmemAccMax ? 1 : 0;
  const size_t smem = smem_acc ? static_cast<size_t>(a.D) * sizeof(float) : 0;
  dense_tiles_kernel<T, kVec><<<a.G, kThreads, smem, a.s>>>(
      a.loss, static_cast<const T*>(a.X), a.y, a.off, a.w, a.coef,
      a.part_val, a.part_grad, a.n, a.D, smem_acc);
  a.parts = a.G;
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Ld, int kChunks, int kGroup>
int launch_rows(DenseArgs& a) {
  const int D = static_cast<int>(a.D);
  dense_rows_kernel<T, Ld, kChunks, kGroup, 1><<<a.G, kThreads, 0, a.s>>>(
      a.loss, static_cast<const T*>(a.X), a.y, a.off, a.w, a.coef,
      a.part_val, a.part_grad, a.n, D, D);
  a.parts = a.G;
  return static_cast<int>(cudaGetLastError());
}

// a load of kLoad pieces a lane-column: up to kRowFloats / N pieces a
// lane, then more warps a row
template <typename T, typename Ld, int kLoad>
int launch_rows_load(DenseArgs& a) {
  constexpr int P = kRowFloats / Ld::N;
  if constexpr (kLoad <= P) {
    return launch_rows<T, Ld, kLoad, 1>(a);
  } else {
    return launch_rows<T, Ld, P, kLoad / P>(a);
  }
}

// the smallest power-of-two load from kLoad up whose row covers D
template <typename T, typename Ld, int kLoad>
int launch_rows_covering(DenseArgs& a) {
  if constexpr (kLoad * Ld::N > kRowFloats * kWarps) {
    return static_cast<int>(cudaErrorInvalidValue);  // D > kBlockCols
  } else {
    if (a.D <= static_cast<long long>(kLoad) * kWarp * Ld::N) {
      return launch_rows_load<T, Ld, kLoad>(a);
    }
    return launch_rows_covering<T, Ld, kLoad * 2>(a);
  }
}

// one element a lane: the fewest warps a row whose lanes hold at most
// kRowFloats values. f32 lanes hold 8, 16 or 32; bf16 lanes 9, 17 or 32,
// so that an intercept width (2^k + 1) fits exactly: with 2-byte loads the
// rows in flight bound the speed, and fewer registers a lane leave room
// for more of them (f32 rows measured faster with the wider lanes)
template <typename T, int kGroup>
int launch_rows_elem_group(DenseArgs& a, int need) {
  using Ld = Elem1<T>;
  constexpr bool kTight = sizeof(T) == 2;
  constexpr int kSmall = kTight ? 9 : 8;
  constexpr int kMid = kTight ? 17 : 16;
  if constexpr (kGroup == 1) {
    if (need <= kSmall) return launch_rows<T, Ld, kSmall, 1>(a);
  }
  // past one warp a row, a group of half as many warps would hold any
  // row needing at most 16 values a lane
  if constexpr (kGroup == 1 || kTight) {
    if (need <= kMid) return launch_rows<T, Ld, kMid, kGroup>(a);
  }
  return launch_rows<T, Ld, kRowFloats, kGroup>(a);
}

template <typename T>
int launch_rows_elem(DenseArgs& a) {
  const long long lanes = kWarp;
  const auto need = [&](int g) {
    return static_cast<int>((a.D + lanes * g - 1) / (lanes * g));
  };
  if (need(1) <= kRowFloats) return launch_rows_elem_group<T, 1>(a, need(1));
  if (need(2) <= kRowFloats) return launch_rows_elem_group<T, 2>(a, need(2));
  if (need(4) <= kRowFloats) return launch_rows_elem_group<T, 4>(a, need(4));
  return launch_rows_elem_group<T, kWarps>(a, need(kWarps));
}

// a row shared by the kCluster blocks of a cluster, slices of S columns
// (a whole number of pieces); one partial a cluster
template <typename T, typename Ld, int kCluster>
int launch_cluster(DenseArgs& a) {
  constexpr int N = Ld::N;
  const int units = a.G < kGridBlocks / kCluster ? a.G
                                                 : kGridBlocks / kCluster;
  const int D = static_cast<int>(a.D);
  const int S = ((D + kCluster - 1) / kCluster + N - 1) / N * N;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(units * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_rows_kernel<T, Ld, kRowFloats / N, kWarps, kCluster>,
      a.loss, static_cast<const T*>(a.X), a.y, a.off, a.w, a.coef,
      a.part_val, a.part_grad, static_cast<int64_t>(a.n), D, S);
  a.parts = units;
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// one loader's forms by width: rows in registers, a cluster a row, tiles
template <typename T, typename Ld, bool kVec>
int launch_width(DenseArgs& a) {
  if (a.D <= kBlockCols) {
    if constexpr (kVec) return launch_rows_covering<T, Ld, 1>(a);
    else return launch_rows_elem<T>(a);
  }
  if (a.D <= 2LL * kBlockCols) return launch_cluster<T, Ld, 2>(a);
  if (a.D <= 4LL * kBlockCols) return launch_cluster<T, Ld, 4>(a);
  if (a.D <= 1LL * kMaxCluster * kBlockCols) {
    return launch_cluster<T, Ld, kMaxCluster>(a);
  }
  return launch_tiles<T, kVec>(a);
}

template <typename T>
int launch_dense(DenseArgs& a) {
  constexpr int N = Vec16<T>::N;
  // 16-byte vector loads need every row to start on a 16-byte boundary;
  // other rows are read an element a lane (at least 8 a lane)
  const bool vec = (reinterpret_cast<uintptr_t>(a.X) % 16) == 0 &&
                   a.D % N == 0;
  return vec ? launch_width<T, Vec16<T>, true>(a)
             : launch_width<T, Elem1<T>, false>(a);
}

// The opt-in to more than 48 KB of dynamic shared memory belongs to the
// kernel in the current device's context, so it is set on every launch.
template <typename T, int kW>
int launch_sparse(int loss, const void* idx, const void* val, const void* y,
                  const void* off, const void* w, const void* coef,
                  float* part_val, float* part_grad, int G, long long n,
                  long long K, long long D, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(1 + kW) * D * sizeof(float) +
                      static_cast<size_t>(kW) * D;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_rows_kernel<T, kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sparse_rows_kernel<T, kW><<<G, kW * kWarp, smem, s>>>(
      loss, static_cast<const int32_t*>(idx), static_cast<const T*>(val),
      static_cast<const float*>(y), static_cast<const float*>(off),
      static_cast<const float*>(w), static_cast<const float*>(coef),
      part_val, part_grad, n, static_cast<int>(K), static_cast<int>(D));
  return static_cast<int>(cudaGetLastError());
}

// eight warps a block where their accumulators leave room for two blocks
// an SM, else four
template <typename T>
int launch_sparse_width(int loss, const void* idx, const void* val,
                        const void* y, const void* off, const void* w,
                        const void* coef, float* part_val, float* part_grad,
                        int G, long long n, long long K, long long D,
                        cudaStream_t s) {
  return D > 2048 ? launch_sparse<T, 4>(loss, idx, val, y, off, w, coef,
                                        part_val, part_grad, G, n, K, D, s)
                  : launch_sparse<T, 8>(loss, idx, val, y, off, w, coef,
                                        part_val, part_grad, G, n, K, D, s);
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
// or null; coef [D] f32; scratch as fused_value_grad_scratch_floats
// sizes it; value [1] and grad [D]
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
              D, static_cast<cudaStream_t>(stream), G};
  const int err = bf16 ? launch_dense<__nv_bfloat16>(a)
                       : launch_dense<float>(a);
  if (err != 0) return err;
  return reduce(a.part_val, a.part_grad, a.parts, D, value, grad, a.s);
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
  const int err =
      bf16 ? launch_sparse_width<__nv_bfloat16>(
                 loss, idx, val, y, off, w, coef, part_val, part_grad, G, n,
                 K, D, s)
           : launch_sparse_width<float>(
                 loss, idx, val, y, off, w, coef, part_val, part_grad, G, n,
                 K, D, s);
  if (err != 0) return err;
  return reduce(part_val, part_grad, G, D, value, grad, s);
}
