// Unsorted segment sum on Hopper: out[g, :] += contrib[b, :] for every row b
// whose segment id is g, ids in ANY order, a few hundred to a few thousand
// segments. Ids outside [0, G) go to the dummy row G.
//
// Replaces the TPU kernel of ceres_tpu/ops/pallas_segment.py:224
// (segment_sum_onehot_tiled, body _kernel_onehot_full :199, wrapper
// segment_sum_onehot :254): one full-height one-hot matmul per 512-row tile
// into a (G_pad, d) table resident in fast memory. What that kernel gives its
// caller is kept: no sort of the rows and no (B, d) row gather before the
// reduction. The one-hot matmul and the 512-row tile are matrix-unit and
// fast-memory devices of the TPU and are not carried over.
//
// Where it runs: the camera-side reductions of the large bundle-adjustment
// case (G = 464 cameras, B = 1.2 M observations): gradient, column norms and
// rmatvec (d <= 9), and the F'F and self-pair cell blocks (d = 81).
//
// What bounds it on this card: memory. It reads B*d contributions and B ids
// once and writes (G+1)*d sums; there is one add per element read.
//
// What the design does about it: each CTA owns a contiguous chunk of rows and
// a chunk of columns and keeps a (G+1) x dc table of partial sums in shared
// memory, so the B*d adds are shared-memory atomics (f32 and f64 both native
// on sm_90) and never reach device memory. A (G+1) x d table does not always
// fit under the 227 KB a block may opt into (465 x 81 f64 = 301 KB), so the
// columns are chunked over grid.y, dc sized from G, the element size and the
// caller's table budget; the ids are re-read per column chunk (4 B against
// d * sizeof(T) of row). Rows are read as they lie: for dc <= 32 a warp reads
// floor(32/dc) rows per step, else each lane owns columns lane, lane+32, ...
// of one row; four rows are in flight per warp. At the end each CTA adds the
// non-zero entries of its table into the zeroed output with global atomics.
//
// Not bit-repeatable: the order of the shared and the global atomic adds
// changes from run to run, so f32 and f64 sums differ in their last bits
// between runs (by a reordering of the same terms).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kUnroll = 4;  // rows in flight per warp (or per row slot)
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the opt-in limit of sm_90

template <typename T>
__global__ void unsorted_segment_sum_kernel(const T* __restrict__ contrib,
                                            const int32_t* __restrict__ ids,
                                            T* __restrict__ out, int64_t B,
                                            int d, int num_rows_out, int dc,
                                            int64_t rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);

  const int c0 = blockIdx.y * dc;
  const int w = (d - c0 < dc) ? d - c0 : dc;  // columns of this chunk
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t r1 = (r0 + rows_per_cta < B) ? r0 + rows_per_cta : B;
  const int n = num_rows_out * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) table[i] = T(0);
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int num_warps = blockDim.x / kWarp;
  const int dummy = num_rows_out - 1;

  if (w <= kWarp) {
    // floor(32/w) rows per warp step: lane -> (row slot, column).
    const int rows_per_step = kWarp / w;
    const int sub = lane / w;
    const int col = lane % w;
    if (sub < rows_per_step) {
      const int64_t stride = static_cast<int64_t>(num_warps) * rows_per_step;
      for (int64_t r = r0 + warp * rows_per_step + sub; r < r1;
           r += kUnroll * stride) {
        T v[kUnroll];
        int g[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t rr = r + u * stride;
          g[u] = -1;
          v[u] = T(0);
          if (rr < r1) {
            const int id = ids[rr];
            g[u] = (id < 0 || id >= dummy) ? dummy : id;
            v[u] = contrib[rr * d + c0 + col];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (g[u] >= 0) atomicAdd(&table[g[u] * w + col], v[u]);
        }
      }
    }
  } else {
    // One row per warp step, lanes on columns lane, lane+32, ...
    for (int64_t r = r0 + warp; r < r1;
         r += static_cast<int64_t>(kUnroll) * num_warps) {
      int g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t rr = r + static_cast<int64_t>(u) * num_warps;
        g[u] = -1;
        if (rr < r1) {
          const int id = ids[rr];
          g[u] = (id < 0 || id >= dummy) ? dummy : id;
        }
      }
      for (int col = lane; col < w; col += kWarp) {
        T v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t rr = r + static_cast<int64_t>(u) * num_warps;
          v[u] = (g[u] >= 0) ? contrib[rr * d + c0 + col] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (g[u] >= 0) atomicAdd(&table[g[u] * w + col], v[u]);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T v = table[i];
    if (v != T(0)) {
      atomicAdd(&out[static_cast<int64_t>(i / w) * d + c0 + (i % w)], v);
    }
  }
}

// Columns per chunk: as many as the table budget holds, evened out over the
// chunks. 0 when not even one column fits.
int columns_per_chunk(int num_rows_out, int d, int elem, int table_bytes) {
  const int64_t fit = static_cast<int64_t>(table_bytes) /
                      (static_cast<int64_t>(num_rows_out) * elem);
  if (fit < 1) return 0;
  const int dc_max = static_cast<int>(fit < d ? fit : d);
  const int chunks = (d + dc_max - 1) / dc_max;
  return (d + chunks - 1) / chunks;
}

template <typename T>
int launch(const void* contrib, const void* ids, void* out, int64_t B, int d,
           int num_rows_out, int table_bytes, int threads, void* stream) {
  if (table_bytes > kMaxSharedBytes) table_bytes = kMaxSharedBytes;
  const int dc = columns_per_chunk(num_rows_out, d, sizeof(T), table_bytes);
  if (dc == 0 || threads < kWarp || threads > 1024 || threads % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (d + dc - 1) / dc;
  const size_t smem = static_cast<size_t>(num_rows_out) * dc * sizeof(T);

  static bool opted_in = false;  // one flag per template instantiation
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        unsorted_segment_sum_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);

  // One wave of CTAs, each with enough rows that zeroing and flushing its
  // table stays a small part of its work.
  int64_t per_sm = kMaxSharedBytes / static_cast<int64_t>(smem + 1024);
  if (per_sm > 2048 / threads) per_sm = 2048 / threads;
  if (per_sm < 1) per_sm = 1;
  int64_t grid_x = (sms * per_sm + chunks - 1) / chunks;
  int64_t min_rows = 8LL * num_rows_out;
  if (min_rows < 256) min_rows = 256;
  const int64_t most = (B + min_rows - 1) / min_rows;
  if (grid_x > most) grid_x = most;
  if (grid_x < 1) grid_x = 1;
  const int64_t rows_per_cta = (B + grid_x - 1) / grid_x;

  const dim3 grid(static_cast<unsigned int>(grid_x),
                  static_cast<unsigned int>(chunks));
  unsorted_segment_sum_kernel<T>
      <<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(contrib), static_cast<const int32_t*>(ids),
          static_cast<T*>(out), B, d, num_rows_out, dc, rows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `out` is
// (num_rows_out, d), ZEROED by the caller; `table_bytes` is the shared-memory
// budget of one CTA's table; `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int unsorted_segment_sum_f32(const void* contrib, const void* ids,
                                        void* out, int64_t B, int d,
                                        int num_rows_out, int table_bytes,
                                        int threads, void* stream) {
  return launch<float>(contrib, ids, out, B, d, num_rows_out, table_bytes,
                       threads, stream);
}

extern "C" int unsorted_segment_sum_f64(const void* contrib, const void* ids,
                                        void* out, int64_t B, int d,
                                        int num_rows_out, int table_bytes,
                                        int threads, void* stream) {
  return launch<double>(contrib, ids, out, B, d, num_rows_out, table_bytes,
                        threads, stream);
}
