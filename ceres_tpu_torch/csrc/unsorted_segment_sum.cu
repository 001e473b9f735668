// Unsorted segment sum on Hopper: out[g, :] = sum of contrib[b, :] over the
// rows b whose segment id is g, ids in ANY order in the caller's array, a few
// hundred to a few thousand segments. Ids outside [0, G) go to the dummy row G.
//
// Replaces the TPU kernel of ceres_tpu/ops/pallas_segment.py:224
// (segment_sum_onehot_tiled, body _kernel_onehot_full :199, wrapper
// segment_sum_onehot :254): one full-height one-hot matmul per 512-row tile
// into a (G_pad, d) table resident in fast memory. What that kernel gives its
// caller is kept: the caller neither sorts its rows nor gathers them into a
// second (B, d) array before the reduction. The one-hot matmul and the
// 512-row tile are matrix-unit and fast-memory devices of the TPU and are not
// carried over.
//
// Where it runs: the camera-side reductions of the large bundle-adjustment
// case (G = 464 cameras, B = 1.2 M observations): gradient, column norms and
// rmatvec (d = 9), and the F'F and self-pair cell blocks (d = 81).
//
// What bounds it on this card: memory. It reads B*d contributions once and
// writes (G+1)*d sums; there is one add per element read.
//
// What the design does about it. The ids of a plan never change, so the host
// sorts them ONCE (ops/unsorted_segment_sum.build_plan_arrays): `perm` lists
// the rows of segment 0, then of segment 1, ... (each in ascending row
// order), and every segment's list is cut evenly into pieces, as few as it
// takes for all pieces together to number no more than the warps the card
// holds at one time (40 an SM).
//   - gather_kernel: one warp owns one piece. It reads its next 32 row numbers
//     with one coalesced load (the batch after that is already on its way),
//     hands them round by shuffle and reads the rows where they lie: lane =
//     column for rows wider than a warp (81 columns: three loads a row), and
//     floor(32/d) rows side by side for narrow ones (d = 9: three rows, 27
//     lanes). The sums stay in registers; a piece leaves as one row of
//     `partial`. All warps are resident at once and have about the same
//     number of rows: one wave, no tail. d = 9 and d = 81 are compiled as
//     constants; every other width takes the run-time form, 32 columns per
//     warp and grid.y column groups.
//   - sum_pieces_kernel: one thread per output element adds its segment's
//     pieces in their order and writes the element, zeros for an empty
//     segment included. So every output element is written exactly once:
//     the output needs no zeroing launch.
// There is no atomic anywhere and every sum is taken in one fixed order
// (rows ascending within a piece's lane slot, slots then pieces ascending):
// the same bits on every run. No table in shared memory, so neither the
// number of segments nor the width is limited by it, and float64 takes the
// same path as float32.
//
// Cutting per segment (and not the whole list into equal runs, which was
// measured too) has a side effect that narrow rows gain from: where the rows
// of the segments lie interleaved in memory, as the cameras' rows do among
// observations sorted by point, piece k of every segment covers the same
// stretch of the array, all warps walk their pieces at the same pace, and two
// rows that share a 32-byte sector are read within microseconds of each
// other, the second from L2 (d = 9: about a fifth faster than with equal
// runs).
//
// What it replaces on this card, and why. The first port kept a (G+1) x d
// table of partial sums per CTA in shared memory, streamed the rows in order
// and added with shared-memory atomics, then flushed with global atomics. On
// sm_90 atomicAdd on shared float and double both compile to a
// compare-and-swap loop (ATOMS.CAST.SPIN, ATOMS.CAST.SPIN.64 in the SASS of
// that kernel: there is no native shared floating-point add), one loop per
// element read; a 465 x 81 float64 table does not fit 227 KB; and its sums
// changed from run to run. A second table kernel that fed those atomics from
// a cp.async ring of 16-byte copies (so that no load waited for an add) was
// built and measured slower than this gather at every shape of the main
// path: with the loads out of the way the compare-and-swap loops are what
// is left. The gather pays for its order with sectors: a 324-byte row
// touches 11 sectors of 32 bytes where 10.1 would do, a 36-byte row two (64
// bytes for 36), and rows read where they lie, three 4-byte-a-lane loads at a
// pitch of 324 bytes, reach about 2.4 TB/s where a sequential pass of 16-byte
// loads reaches 3.1 TB/s on the same card (tools/sweep_kernels.py k3:
// gather_ms beside stream_ms). Loading the rows
// as aligned 16-byte vectors, and an order of the pieces that keeps
// concurrent warps inside one window of the array, were both measured and
// changed nothing; they are not kept.
//
// A segment with very many rows has many pieces, which sum_pieces_kernel adds
// one after another in one thread per column (correct; bundle adjustment's
// cameras hold 2400 to 2800 rows, eleven pieces). Byte offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned int kFullMask = 0xffffffffu;
constexpr int kThreads = 128;

// Row loads a lane keeps in flight, chosen so that every form of the kernel
// stays within 48 registers and the 40 warps an SM that the plan counts on
// are resident at once (nvcc 12 -Xptxas -v: 32 to 44). Wide rows (three
// loads a row): from 2 to 8 rows the time moved by under 5% (d = 81), so they
// take the fewest registers. Narrow constant widths in float32 take a whole
// batch of 32 rows.
template <typename T, int D>
struct RowsInFlight {
  static constexpr int kSlots = (D > 0 && D <= kWarp) ? kWarp / (D > 0 ? D : 1) : 1;
  static constexpr int kNarrow = sizeof(T) == 4 ? (kWarp + kSlots - 1) / kSlots : 4;
  static constexpr int kWide = sizeof(T) == 4 ? 4 : 2;
  // the run-time form (D == 0) has one load a row
  static constexpr int value = D == 0 ? 4 : (D <= kWarp ? kNarrow : kWide);
};

// D > 0: the width as a constant; D == 0: the run-time form, 32 columns of
// `d_run` per warp, column group blockIdx.y.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ contrib,
                  const int32_t* __restrict__ perm,
                  const int32_t* __restrict__ piece_ptr,
                  T* __restrict__ partial, int num_pieces, int d_run) {
  constexpr int kPass = D > 0 ? (D + kWarp - 1) / kWarp : 1;
  constexpr int kRows = RowsInFlight<T, D>::value;
  const int lane = threadIdx.x % kWarp;
  const int piece = blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (piece >= num_pieces) return;  // whole warps leave; no block-wide barrier
  const int d = D > 0 ? D : d_run;
  const int slots = d <= kWarp ? kWarp / d : 1;  // rows side by side
  const int slot = d <= kWarp ? lane / d : 0;
  const int lcol = lane - slot * d;
  const bool lane_on = slot < slots;
  const int c0 = blockIdx.y * kWarp * kPass;
  T acc[kPass];
#pragma unroll
  for (int p = 0; p < kPass; ++p) acc[p] = T(0);

  const int begin = piece_ptr[piece];
  const int end = piece_ptr[piece + 1];
  int next = begin + lane < end ? perm[begin + lane] : 0;
  for (int base = begin; base < end; base += kWarp) {
    const int n = end - base < kWarp ? end - base : kWarp;
    const int mine = next;  // lane q holds row number q of this batch
    next = base + kWarp + lane < end ? perm[base + kWarp + lane] : 0;
    for (int q0 = 0; q0 < n; q0 += kRows * slots) {
      T v[kRows][kPass];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int q = q0 + u * slots + slot;
        const int64_t r = __shfl_sync(kFullMask, mine, q & (kWarp - 1));
        const bool ok = lane_on && q < n;
#pragma unroll
        for (int p = 0; p < kPass; ++p) {
          const int col = c0 + p * kWarp + lcol;
          v[u][p] = (ok && col < d) ? contrib[r * d + col] : T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int p = 0; p < kPass; ++p) acc[p] += v[u][p];
      }
    }
  }
  // Fold the row slots into slot 0: slot 0 + slot 1 + ..., in that order.
  if (slots > 1) {
    T total = acc[0];
    for (int s = 1; s < slots; ++s) {
      total += __shfl_down_sync(kFullMask, acc[0], s * d);
    }
    acc[0] = total;
  }
  if (slot == 0) {
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int col = c0 + p * kWarp + lcol;
      if (col < d) partial[static_cast<int64_t>(piece) * d + col] = acc[p];
    }
  }
}

// out[g, col] = partial[p, col] summed over the pieces p of segment g, in
// their order. One thread per output element.
template <typename T>
__global__ void sum_pieces_kernel(const T* __restrict__ partial,
                                  const int32_t* __restrict__ seg_piece_ptr,
                                  T* __restrict__ out, int64_t n_out, int d) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int g = static_cast<int>(i / d);
  const int col = static_cast<int>(i - static_cast<int64_t>(g) * d);
  T s = T(0);
  const int p1 = seg_piece_ptr[g + 1];
#pragma unroll 4
  for (int p = seg_piece_ptr[g]; p < p1; ++p) {
    s += partial[static_cast<int64_t>(p) * d + col];
  }
  out[i] = s;
}

// A yardstick for the measuring tools, never on a solve's path: read `n`
// 16-byte vectors in order, four loads in flight per thread, and add them up.
__global__ void stream_kernel(const float4* __restrict__ x, int64_t n,
                              float* __restrict__ out) {
  float s = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (; i + 3 * stride < n; i += 4 * stride) {
    const float4 a = x[i], b = x[i + stride], c = x[i + 2 * stride],
                 e = x[i + 3 * stride];
    s += (a.x + a.y + a.z + a.w) + (b.x + b.y + b.z + b.w) +
         (c.x + c.y + c.z + c.w) + (e.x + e.y + e.z + e.w);
  }
  for (; i < n; i += stride) {
    const float4 a = x[i];
    s += a.x + a.y + a.z + a.w;
  }
  if (s == -1.2345e30f) out[0] = s;  // keeps the loads; never true in practice
}

constexpr int kGather = 1;  // bits of `stages`
constexpr int kSum = 2;

template <typename T>
int launch(const void* contrib, const void* perm, const void* piece_ptr,
           const void* seg_piece_ptr, void* partial, void* out,
           int num_pieces, int d, int num_rows_out, int compile_time,
           int stages, void* stream_v) {
  if (d < 1 || num_rows_out < 1 || num_pieces < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  constexpr int kWarps = kThreads / kWarp;
  const unsigned int blocks =
      static_cast<unsigned int>((num_pieces + kWarps - 1) / kWarps);
  const T* c = static_cast<const T*>(contrib);
  const int32_t* rows = static_cast<const int32_t*>(perm);
  const int32_t* pieces = static_cast<const int32_t*>(piece_ptr);
  T* part = static_cast<T*>(partial);
  if ((stages & kGather) && num_pieces > 0) {
    if (compile_time && d == 81) {
      gather_kernel<T, 81><<<blocks, kThreads, 0, stream>>>(c, rows, pieces,
                                                            part, num_pieces, d);
    } else if (compile_time && d == 9) {
      gather_kernel<T, 9><<<blocks, kThreads, 0, stream>>>(c, rows, pieces,
                                                           part, num_pieces, d);
    } else if (compile_time) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      const dim3 grid(blocks, (d + kWarp - 1) / kWarp);
      gather_kernel<T, 0><<<grid, kThreads, 0, stream>>>(c, rows, pieces, part,
                                                         num_pieces, d);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (stages & kSum) {
    const int64_t n_out = static_cast<int64_t>(num_rows_out) * d;
    const unsigned int grid = static_cast<unsigned int>((n_out + 255) / 256);
    sum_pieces_kernel<T><<<grid, 256, 0, stream>>>(
        part, static_cast<const int32_t*>(seg_piece_ptr), static_cast<T*>(out),
        n_out, d);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: contrib (B, d)
// row-major; perm (B,) int32, the rows of segment 0, 1, ..., G in turn;
// piece_ptr (num_pieces + 1,) int32 over perm, no piece across two segments;
// seg_piece_ptr (num_rows_out + 1,) int32, the pieces of each segment;
// partial (num_pieces, d) scratch; out (num_rows_out, d), every element of
// which is written. `compile_time` != 0 asks for the constant-width form
// (d = 9 or 81 only); `stages` is 3 (1 = gather only, 2 = sum of the pieces
// only: for the measuring tools); `stream` is a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int unsorted_segment_sum_f32(
    const void* contrib, const void* perm, const void* piece_ptr,
    const void* seg_piece_ptr, void* partial, void* out, int num_pieces, int d,
    int num_rows_out, int compile_time, int stages, void* stream) {
  return launch<float>(contrib, perm, piece_ptr, seg_piece_ptr, partial, out,
                       num_pieces, d, num_rows_out, compile_time, stages,
                       stream);
}

extern "C" int unsorted_segment_sum_f64(
    const void* contrib, const void* perm, const void* piece_ptr,
    const void* seg_piece_ptr, void* partial, void* out, int num_pieces, int d,
    int num_rows_out, int compile_time, int stages, void* stream) {
  return launch<double>(contrib, perm, piece_ptr, seg_piece_ptr, partial, out,
                        num_pieces, d, num_rows_out, compile_time, stages,
                        stream);
}

// The streaming yardstick: reads `num_bytes` (a multiple of 16, 16-byte
// aligned) at `x` once; `out` is one float of scratch.
extern "C" int unsorted_segment_sum_stream(const void* x, int64_t num_bytes,
                                           void* out, int blocks, int threads,
                                           void* stream) {
  if (num_bytes % 16 != 0 || blocks < 1 || threads < 1 || threads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stream_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), num_bytes / 16, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
