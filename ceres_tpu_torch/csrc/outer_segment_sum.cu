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
// What bounds it on this card: memory. Per pair it reads two index values and
// K*(T1+T2) operand values (54 at the shapes above) for 2*K*T1*T2 = 486
// flops, about 2 flops per byte; the rows are gathered, so each read is a
// short 108-byte run at a data-dependent address.
//
// What the design does about it: one warp owns one cell and walks its pairs
// in their stored order. The warp stages the operand rows of up to 8 pairs at
// a time in shared memory (32 lanes loading 8 * 54 values keep a dozen loads
// in flight per lane), then each lane accumulates its own output elements
// (lane, lane + 32, lane + 64, ... of the T1*T2) in registers from the staged
// rows, and at the end writes them: every output row is written exactly
// once, by one warp, in a fixed order. No atomics, no zeroing pass, the same
// bits on every run. A cell with thousands of pairs is walked by its one warp
// (correct; splitting such cells is later work). All offsets are 64-bit: the
// byte offset of pair 3 M * 81 values would overflow 32 bits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kAcc = 4;  // output elements per lane and pass (T1*T2 <= 128)
constexpr int kMaxStage = 8;  // pairs staged per step
constexpr int kStaticSharedBytes = 48 * 1024;

template <typename T>
__global__ void outer_segment_sum_kernel(
    const T* __restrict__ W, const T* __restrict__ Y,
    const int64_t* __restrict__ a_idx, const int64_t* __restrict__ b_idx,
    const int32_t* __restrict__ row_ptr, T* __restrict__ out,
    int64_t num_cells, int K, int T1, int T2, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int warp_in_block = threadIdx.x / kWarp;
  const int64_t cell =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp_in_block;
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
        staged[idx] = (q < kt1) ? W[a_idx[p0 + pp] * kt1 + q]
                                : Y[b_idx[p0 + pp] * kt2 + (q - kt1)];
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
           int T2, void* stream) {
  if (K < 1 || T1 < 1 || T2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = static_cast<int64_t>(K) * (T1 + T2) * sizeof(T);
  int64_t stage = kStaticSharedBytes / (row_bytes * kWarpsPerBlock);
  if (stage > kMaxStage) stage = kMaxStage;
  if (stage < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(stage * row_bytes * kWarpsPerBlock);
  const int64_t blocks = (num_cells + kWarpsPerBlock - 1) / kWarpsPerBlock;
  outer_segment_sum_kernel<T>
      <<<static_cast<unsigned int>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(W), static_cast<const T*>(Y),
          static_cast<const int64_t*>(a_idx),
          static_cast<const int64_t*>(b_idx),
          static_cast<const int32_t*>(row_ptr), static_cast<T*>(out),
          num_cells, K, T1, T2, static_cast<int>(stage));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: W (rows, K*T1)
// and Y (rows, K*T2) row-major, a_idx / b_idx (pairs,) int64 row numbers,
// row_ptr (num_cells + 1,) int32 over the cell-sorted pairs, out
// (num_cells, T1*T2), every row of which is written. `stream` is a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int outer_segment_sum_f32(const void* W, const void* Y,
                                     const void* a_idx, const void* b_idx,
                                     const void* row_ptr, void* out,
                                     int64_t num_cells, int K, int T1, int T2,
                                     void* stream) {
  return launch<float>(W, Y, a_idx, b_idx, row_ptr, out, num_cells, K, T1, T2,
                       stream);
}

extern "C" int outer_segment_sum_f64(const void* W, const void* Y,
                                     const void* a_idx, const void* b_idx,
                                     const void* row_ptr, void* out,
                                     int64_t num_cells, int K, int T1, int T2,
                                     void* stream) {
  return launch<double>(W, Y, a_idx, b_idx, row_ptr, out, num_cells, K, T1, T2,
                        stream);
}
