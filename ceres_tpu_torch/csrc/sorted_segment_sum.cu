// Sorted segment sum on Hopper: out[g, :] = sum of contrib[b, :] over the
// rows b whose (sorted) segment id is g.
//
// Replaces the TPU kernels of ceres_tpu/ops/pallas_segment.py:
//   - sorted_segment_sum_blocked (_kernel_blocked), the large-G form that
//     carries every point-side reduction of the BAL solve (gradient and
//     rmatvec for the points, E'E and E'w of the Schur eliminator);
//   - sorted_segment_sum (_kernel), the same function with the whole output
//     table resident, for smaller G.
// Both become the one kernel of this file. The TPU design (one-hot MXU matmul
// per row tile, VMEM output windows, scalar-prefetch routing, halo
// overlap-add) exists because of VMEM and is not carried over.
//
// What bounds it on this card: by its bytes it is memory-bound (B*d
// contributions and G+2 row pointers read once, (G+1)*d sums written once,
// one add per element read). At the shapes bundle adjustment gives it the
// segments are tiny and uniform (a point is seen by 3 to 6 cameras, d is 3 or
// 9), and then what a design spends per SEGMENT decides: a warp per segment
// makes one load on 18 of its 32 lanes after two dependent row-pointer
// loads and folds the lanes with ten shuffles to write 12 bytes; 200 000
// such warps take eleven times the byte bound, bound by instructions and
// latency per warp.
//
// What the design does about it: the host plan turns the sorted ids into a
// CSR row pointer (row_ptr[g] .. row_ptr[g+1] are the rows of segment g), so
// each segment is one contiguous slab of B*d memory, and one THREAD takes one
// output element (g, c). Neighbouring lanes hold neighbouring columns and
// then neighbouring segments, so a warp covers 32/d segments whose rows are
// one contiguous slab; every lane is used whatever d is, the loads of up to
// kBatch rows are in flight together, and the 32 sums are written as one
// coalesced store. d = 3 and d = 9 are compile-time instantiations (the
// division t -> (g, c) is by a constant); every other d takes the run-time
// form.
//
// Every output row is written exactly once, each element by one thread that
// adds its rows one after another in their stored order: no atomics, no
// second pass, and the same bits on every run. The kernel is right for every
// row pointer. A long segment is walked by d threads alone (a lone segment
// of 4096 rows among 200 000 short ones costs about 0.09 ms at d = 3 on an
// H100); the solver's sorted plans (points seen by a few cameras each) hold
// no such segments, and its long-segment reductions (the camera side) go to
// the unsorted kernel, so no second kernel is built for them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kBatch = 8;  // rows whose loads one thread keeps in flight

// One thread per output element. D > 0: the width at compile time.
template <typename T, int D>
__global__ void element_kernel(const T* __restrict__ contrib,
                               const int32_t* __restrict__ row_ptr,
                               T* __restrict__ out, int64_t num_elements,
                               int d_run) {
  const int d = D > 0 ? D : d_run;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= num_elements) return;
  int64_t g;
  int c;
  if (num_elements <= INT32_MAX) {  // the same branch for every thread
    const uint32_t t32 = static_cast<uint32_t>(t);
    const uint32_t g32 = t32 / static_cast<uint32_t>(d);
    g = g32;
    c = static_cast<int>(t32 - g32 * static_cast<uint32_t>(d));
  } else {
    g = t / d;
    c = static_cast<int>(t - g * d);
  }
  const int64_t begin = row_ptr[g];
  const int n = static_cast<int>(row_ptr[g + 1] - begin);
  const T* p = contrib + begin * d + c;
  T acc = T(0);
  for (int r = 0; r < n; r += kBatch, p += static_cast<int64_t>(kBatch) * d) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      v[i] = (r + i < n) ? p[static_cast<int64_t>(i) * d] : T(0);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (r + i < n) acc += v[i];  // rows in their stored order
    }
  }
  out[t] = acc;
}

template <typename T>
int launch(const void* contrib_v, const void* row_ptr_v, void* out_v,
           int64_t num_segments, int d, int threads, void* stream_v) {
  if (d < 1 || threads < kWarp || threads > 1024 || threads % kWarp != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* contrib = static_cast<const T*>(contrib_v);
  const int32_t* row_ptr = static_cast<const int32_t*>(row_ptr_v);
  T* out = static_cast<T*>(out_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const int64_t work = num_segments * d;  // one thread per output element
  const int64_t blocks = (work + threads - 1) / threads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  if (d == 3) {
    element_kernel<T, 3><<<grid, threads, 0, stream>>>(contrib, row_ptr, out,
                                                       work, d);
  } else if (d == 9) {
    element_kernel<T, 9><<<grid, threads, 0, stream>>>(contrib, row_ptr, out,
                                                       work, d);
  } else {
    element_kernel<T, 0><<<grid, threads, 0, stream>>>(contrib, row_ptr, out,
                                                       work, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers; `threads` is
// the block size (a multiple of 32); `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int sorted_segment_sum_f32(const void* contrib, const void* row_ptr,
                                      void* out, int64_t num_segments, int d,
                                      int threads, void* stream) {
  return launch<float>(contrib, row_ptr, out, num_segments, d, threads,
                       stream);
}

extern "C" int sorted_segment_sum_f64(const void* contrib, const void* row_ptr,
                                      void* out, int64_t num_segments, int d,
                                      int threads, void* stream) {
  return launch<double>(contrib, row_ptr, out, num_segments, d, threads,
                        stream);
}
