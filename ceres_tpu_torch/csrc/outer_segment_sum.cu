// Fused pair-outer segment sum on Hopper. For every cell g (a contiguous run
// of pair rows p in a cell-sorted pair list, CSR row pointer):
//
//   out[g, i*T2 + j] = sum_p sum_k W[a_idx[p], k*T1 + i] * Y[b_idx[p], k*T2 + j]
//
// Replaces the TPU kernel of ceres_tpu/ops/pallas_segment.py:504
// (_outer_segment_sum_blocked_impl, body _kernel_blocked_outer :461, wrapper
// outer_segment_sum_blocked :587), called where the explicit Schur complement
// reduces the correction terms -W_a' M^-1 W_b of every pair of observations of
// a point into camera-pair cells (about 3 M pairs into about 107 k cells at
// 464 cameras / 1.2 M observations; K = 3, T1 = T2 = 9, 81 values per pair).
// What that kernel keeps out of device memory is kept out here too: the
// (pairs, T1*T2) array of outer products never exists. On the TPU the operand
// rows W[a_idx], Y[b_idx] were gathered into (pairs, K*T) arrays before the
// kernel; here the kernel gathers them itself, so those copies do not exist
// either. The 0/1 selection matmuls that formed the outer product on the
// matrix unit are not carried over: the K-term product is plain FMAs.
//
// What bounds it on this card. By its bytes (slabs, pair lists and output
// once) it is memory-bound: K*(T1+T2) = 54 operand values per pair for
// 2*K*T1*T2 = 486 flops. But the rows are GATHERED: every pair reads two
// 108-byte rows (float32) at data-dependent addresses, a row touches 4 or 5
// sectors of 32 bytes (4.25 on average: only every fourth row starts on a
// 16-byte boundary), and a row is wanted by about three pairs, from slabs
// (2 x 130 MB) larger than the 50 MB L2. What the cell order gives: cells are
// sorted by (row camera, column camera), so the few hundred cells of one row
// camera follow one another and their W rows (that camera's observations,
// about 0.3 MB) are found again in L2; the Y rows of one column camera are
// wanted by cells spread over the whole list and mostly come from device
// memory each time. The honest floor is therefore the sectors gathered that
// L2 cannot serve, not the slabs once. And a kernel only gets there if its
// instructions stay out of the way: with K, T1, T2 run-time values (the
// run-time form below) every FMA costs two shared loads with computed
// addresses, staging divides per element, and each step's gather, barrier
// and compute run one after another, which binds it by its instruction count at
// ten times the byte bound.
//
// What the design does about it.
//   - The main path's shape (K = 3, T1 = T2 = 9) is a compile-time
//     instantiation, fully unrolled (`tiled_kernel`). One warp owns one cell.
//     A lane holds a 3 x 3 block of the 9 x 9 output in registers; nine lanes
//     cover one pair, so three pairs are multiplied at once on 27 lanes. Per
//     k a lane loads 3 + 3 operand values from shared memory for 9 FMAs (the
//     run-time form loads 18), at addresses that are constants plus one
//     base, free of bank conflicts (pair stride 54 words).
//   - Staging is asynchronous and double-buffered: the rows of the next
//     `stage` pairs are copied global -> shared with cp.async (one
//     instruction per row, lane = word, 4 bytes in float32 and 8 in float64,
//     the widest the 108-byte row pitch allows) while the present ones are
//     multiplied, and the pair indices of the stage after that are already
//     in registers (lane q holds pair q's, read once, int32, handed round by
//     shuffle). No division, no barrier across warps.
//   - The three pair slots' partial sums are folded in a fixed order by
//     shuffles, the 81 sums go through shared memory and leave as three
//     coalesced stores. Every output row is written exactly once, by one
//     warp, which adds its pairs in a fixed order: no atomics, no zeroing
//     pass, the same bits on every run.
//   - Every other (K, T1, T2) takes `general_kernel`, the run-time form: one
//     warp per cell, up to 8 pairs staged per step, each lane accumulating
//     output elements lane, lane + 32, ... in registers.
// A cell with thousands of pairs is walked by its one warp (correct; the
// cells of bundle adjustment hold 8 to 57 pairs). Byte offsets are 64-bit:
// pair 3 M * 81 values would overflow 32 bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned int kFullMask = 0xffffffffu;
constexpr int kMaxSharedBytes = 227 * 1024;

// ---- the compile-time form ---------------------------------------------------

constexpr int kTile = 3;  // a lane's block of the output is kTile x kTile

template <int BYTES>
__device__ __forceinline__ void cp_async(void* shared, const void* global) {
  const unsigned int dst =
      static_cast<unsigned int>(__cvta_generic_to_shared(shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(global), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <typename T, int K, int T1, int T2>
__global__ void tiled_kernel(const T* __restrict__ W, const T* __restrict__ Y,
                             const int32_t* __restrict__ a_idx,
                             const int32_t* __restrict__ b_idx,
                             const int32_t* __restrict__ row_ptr,
                             T* __restrict__ out, int64_t num_cells,
                             int stage) {
  static_assert(T1 % kTile == 0 && T2 % kTile == 0, "output not tileable");
  constexpr int kTilesJ = T2 / kTile;
  constexpr int kTiles = (T1 / kTile) * kTilesJ;  // lanes per pair
  constexpr int kSlots = kWarp / kTiles;          // pairs multiplied at once
  constexpr int kRowW = K * T1;
  constexpr int kRowY = K * T2;
  constexpr int kRow = kRowW + kRowY;  // staged values per pair
  constexpr int kOut = T1 * T2;
  static_assert(kSlots >= 1 && kRowW <= kWarp && kRowY <= kWarp, "shape");
  static_assert(2 * kRow >= kOut, "the output row is staged in the buffers");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp_in_block = threadIdx.x / kWarp;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp_in_block;
  if (cell >= num_cells) return;  // whole warps leave; no block-wide barrier

  // This warp's two staging buffers of `stage` pairs each.
  T* buf = reinterpret_cast<T*>(smem_raw) +
           static_cast<int64_t>(warp_in_block) * 2 * stage * kRow;
  const int begin = row_ptr[cell];
  const int npairs = row_ptr[cell + 1] - begin;
  const int nstages = (npairs + stage - 1) / stage;

  const int slot = lane / kTiles;
  const int tile = lane - slot * kTiles;
  const int wi = (tile / kTilesJ) * kTile;          // first output row
  const int yj = kRowW + (tile % kTilesJ) * kTile;  // first output column
  T acc[kTile][kTile];
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
#pragma unroll
    for (int v = 0; v < kTile; ++v) acc[u][v] = T(0);
  }

  // Lane q < stage holds the slab rows of pair q of a stage.
  int ia = 0, ib = 0;
  auto load_indices = [&](int st) {
    const int q = st * stage + lane;
    const bool mine = lane < stage && q < npairs;
    ia = mine ? a_idx[begin + q] : 0;
    ib = mine ? b_idx[begin + q] : 0;
  };
  auto copy_stage = [&](int st) {
    T* dst = buf + (st & 1) * stage * kRow;
    const int left = npairs - st * stage;
    const int np = left < stage ? left : stage;
    for (int q = 0; q < np; ++q, dst += kRow) {
      const int64_t ra = __shfl_sync(kFullMask, ia, q);
      const int64_t rb = __shfl_sync(kFullMask, ib, q);
      if (lane < kRowW) cp_async<sizeof(T)>(dst + lane, W + ra * kRowW + lane);
      if (lane < kRowY) {
        cp_async<sizeof(T)>(dst + kRowW + lane, Y + rb * kRowY + lane);
      }
    }
    cp_async_commit();
  };

  load_indices(0);
  if (nstages > 0) copy_stage(0);
  load_indices(1);
  for (int st = 0; st < nstages; ++st) {
    if (st + 1 < nstages) {
      copy_stage(st + 1);
      load_indices(st + 2);
      cp_async_wait<1>();  // stage st has landed; st + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const T* cur = buf + (st & 1) * stage * kRow;
    const int left = npairs - st * stage;
    const int np = left < stage ? left : stage;
    if (slot < kSlots) {
      for (int q = slot; q < np; q += kSlots) {
        const T* row = cur + q * kRow;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          T w[kTile], y[kTile];
#pragma unroll
          for (int u = 0; u < kTile; ++u) w[u] = row[k * T1 + wi + u];
#pragma unroll
          for (int v = 0; v < kTile; ++v) y[v] = row[k * T2 + yj + v];
#pragma unroll
          for (int u = 0; u < kTile; ++u) {
#pragma unroll
            for (int v = 0; v < kTile; ++v) acc[u][v] += w[u] * y[v];
          }
        }
      }
    }
    __syncwarp();  // the buffer may be overwritten two stages on
  }

  // Fold the slots into slot 0 (slot 0 + slot 1 + slot 2, in that order),
  // lay the row out in shared memory, write it with coalesced stores.
#pragma unroll
  for (int u = 0; u < kTile; ++u) {
#pragma unroll
    for (int v = 0; v < kTile; ++v) {
      T total = acc[u][v];
#pragma unroll
      for (int s = 1; s < kSlots; ++s) {
        total += __shfl_down_sync(kFullMask, acc[u][v], s * kTiles);
      }
      if (lane < kTiles) buf[(wi + u) * T2 + (yj - kRowW) + v] = total;
    }
  }
  __syncwarp();
  T* dst = out + cell * kOut;
  for (int e = lane; e < kOut; e += kWarp) dst[e] = buf[e];
}

// ---- the run-time form -------------------------------------------------------

constexpr int kAcc = 4;  // output elements per lane and pass (T1*T2 <= 128)
constexpr int kMaxStage = 8;  // pairs staged per step
constexpr int kGeneralSharedBytes = 48 * 1024;

template <typename T>
__global__ void general_kernel(
    const T* __restrict__ W, const T* __restrict__ Y,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ b_idx,
    const int32_t* __restrict__ row_ptr, T* __restrict__ out,
    int64_t num_cells, int K, int T1, int T2, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp_in_block = threadIdx.x / kWarp;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp_in_block;
  if (cell >= num_cells) return;  // whole warps leave; no block-wide barrier

  const int kt1 = K * T1;
  const int kt2 = K * T2;
  const int row_len = kt1 + kt2;  // staged values per pair: W row, then Y row
  const int d_out = T1 * T2;
  T* staged = reinterpret_cast<T*>(smem_raw) +
              static_cast<int64_t>(warp_in_block) * stage * row_len;

  const int64_t begin = row_ptr[cell];
  const int64_t end = row_ptr[cell + 1];
  T* dst = out + cell * d_out;

  // Passes of 32 * kAcc output elements; one pass when T1*T2 <= 128.
  for (int e0 = 0; e0 < d_out; e0 += kWarp * kAcc) {
    T acc[kAcc];
    int wi[kAcc], yj[kAcc];
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      const int e = e0 + u * kWarp + lane;
      acc[u] = T(0);
      wi[u] = (e < d_out) ? e / T2 : -1;
      yj[u] = (e < d_out) ? kt1 + e % T2 : 0;
    }
    for (int64_t p0 = begin; p0 < end; p0 += stage) {
      const int64_t left = end - p0;
      const int np = static_cast<int>(left < stage ? left : stage);
      const int n = np * row_len;
      __syncwarp();  // the previous step's reads are done
      for (int idx = lane; idx < n; idx += kWarp) {
        const int pp = idx / row_len;
        const int q = idx - pp * row_len;
        staged[idx] =
            (q < kt1) ? W[static_cast<int64_t>(a_idx[p0 + pp]) * kt1 + q]
                      : Y[static_cast<int64_t>(b_idx[p0 + pp]) * kt2 + (q - kt1)];
      }
      __syncwarp();
      for (int pp = 0; pp < np; ++pp) {
        const T* row = staged + pp * row_len;
#pragma unroll
        for (int u = 0; u < kAcc; ++u) {
          if (wi[u] >= 0) {
            T s = T(0);
            for (int k = 0; k < K; ++k) {
              s += row[k * T1 + wi[u]] * row[k * T2 + yj[u]];
            }
            acc[u] += s;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kAcc; ++u) {
      if (wi[u] >= 0) dst[e0 + u * kWarp + lane] = acc[u];
    }
  }
}

template <typename T>
int launch(const void* W, const void* Y, const void* a_idx, const void* b_idx,
           const void* row_ptr, void* out, int64_t num_cells, int K, int T1,
           int T2, int tiled, int threads, int stage, void* stream_v) {
  if (K < 1 || T1 < 1 || T2 < 1 || threads < kWarp || threads > 1024 ||
      threads % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const int warps = threads / kWarp;
  const int64_t blocks = (num_cells + warps - 1) / warps;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  const int64_t row_bytes = static_cast<int64_t>(K) * (T1 + T2) * sizeof(T);
  if (tiled) {
    if (K != 3 || T1 != 9 || T2 != 9 || stage < 1 || stage > kWarp) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int64_t smem = 2 * stage * row_bytes * warps;
    if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = tiled_kernel<T, 3, 9, 9>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, threads, static_cast<size_t>(smem), stream>>>(
        static_cast<const T*>(W), static_cast<const T*>(Y),
        static_cast<const int32_t*>(a_idx), static_cast<const int32_t*>(b_idx),
        static_cast<const int32_t*>(row_ptr), static_cast<T*>(out), num_cells,
        stage);
    return static_cast<int>(cudaGetLastError());
  }
  int64_t general_stage = kGeneralSharedBytes / (row_bytes * warps);
  if (general_stage > kMaxStage) general_stage = kMaxStage;
  if (general_stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(general_stage * row_bytes * warps);
  general_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(W), static_cast<const T*>(Y),
      static_cast<const int32_t*>(a_idx), static_cast<const int32_t*>(b_idx),
      static_cast<const int32_t*>(row_ptr), static_cast<T*>(out), num_cells, K,
      T1, T2, static_cast<int>(general_stage));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: W (rows, K*T1)
// and Y (rows, K*T2) row-major, a_idx / b_idx (pairs,) int32 row numbers,
// row_ptr (num_cells + 1,) int32 over the cell-sorted pairs, out
// (num_cells, T1*T2), every row of which is written. `tiled` != 0 asks for
// the compile-time form (K = 3, T1 = T2 = 9 only) with `stage` pairs per
// staging buffer; `threads` is the block size (a multiple of 32); `stream` is
// a cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int outer_segment_sum_f32(const void* W, const void* Y,
                                     const void* a_idx, const void* b_idx,
                                     const void* row_ptr, void* out,
                                     int64_t num_cells, int K, int T1, int T2,
                                     int tiled, int threads, int stage,
                                     void* stream) {
  return launch<float>(W, Y, a_idx, b_idx, row_ptr, out, num_cells, K, T1, T2,
                       tiled, threads, stage, stream);
}

extern "C" int outer_segment_sum_f64(const void* W, const void* Y,
                                     const void* a_idx, const void* b_idx,
                                     const void* row_ptr, void* out,
                                     int64_t num_cells, int K, int T1, int T2,
                                     int tiled, int threads, int stage,
                                     void* stream) {
  return launch<double>(W, Y, a_idx, b_idx, row_ptr, out, num_cells, K, T1, T2,
                        tiled, threads, stage, stream);
}
