// The Snavely reprojection residual of bundle adjustment and its Jacobian,
// one observation a thread, in one pass:
//
//   r   = f * d(|x|^2) * x - observed,  x = -(P_xy / P_z),  P = R(aa) X + t,
//   d   = 1 + |x|^2 (k1 + k2 |x|^2)        (snavely_reprojection_error.h)
//
// with the camera (aa, t, f, k1, k2) and the point X read through each
// observation's rows into the (C, 9) and (P, 3) tables of the state. Outputs:
// r (B, 2), J_cam (B, 2, 9) and J_pt (B, 2, 3), contiguous; or r alone.
//
// Replaces no TPU kernel: on the TPU, as in the port's other families,
// the residual is differentiated by vmap(jacfwd) (ceres_tpu_torch/
// evaluator.py), which XLA fuses there. Under PyTorch that becomes some 200
// separate kernels over (B, 12, .) tangent tensors: about 55 GB read and
// written an evaluation at 1.26 M observations, 100 to 300 times the bytes
// the work needs. This kernel is the fused form that
// ceres_tpu_torch/models/bal.py registers on the residual; the evaluator
// takes it on the card.
//
// What bounds it on this card: its bytes. Per observation it reads two
// int64 rows, two observed values and (once per point, as observations come
// sorted by point) three point values; the 356 cameras of the largest case
// are 25 KB, read from L2. It writes 26 values. In float64 that is about 245
// bytes an observation against some 600 to 1 500 flops, most of them the
// 12 tangents and the divisions and sin / cos of the Rodrigues rotation:
// below the card's machine balance, so the intermediates stay in registers.
//
// What the design does about it.
//   - Forward-mode dual numbers (`Dual<T, N>`): a value and N tangents in
//     registers, through exactly the operations of
//     ceres_tpu_torch/models/bal.py's snavely_reprojection_residual and
//     rotation.angle_axis_rotate_point (the theta^2 < 1e-24 first-order
//     branch, the -z projection, the two-term distortion), so the Jacobian
//     is the chain rule jacfwd applies and agrees with it to rounding. The
//     tangents are carried only where they can be non-zero: 6 (the
//     angle-axis and the point) through the rotation, 9 (with the
//     translation) through the projection, all 12 from the distortion on.
//     A zero tangent left out is what jacfwd adds as an exact zero.
//   - A tangent of a quotient multiplies by the divisor's reciprocal, one
//     division a quotient in place of N (the values themselves are divided as
//     the residual divides them).
//   - Stores: each thread's 26 values go to shared memory (stride 27, odd, so
//     a warp's writes hit distinct banks), and the block writes its rows of
//     r, J_cam and J_pt back as three contiguous runs, one value a thread a
//     step, coalesced. The residual-only form needs no staging: a thread's
//     two values are next to its neighbours'.
// No atomics and no order-dependent sum: the same bits on every run,
// captured or eager.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // observations a block
constexpr int kOut = 26;       // r (2), J_cam (2 x 9), J_pt (2 x 3)
constexpr int kStride = 27;    // shared-memory row of one observation

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }

// A value and its N tangents. N = 0 (the residual-only form) keeps one unused
// slot, which the compiler drops.
template <typename T, int N>
struct Dual {
  T v;
  T d[N > 0 ? N : 1];
};

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> constant(T v) {
  Dual<T, N> r;
  r.v = v;
#pragma unroll
  for (int q = 0; q < (N > 0 ? N : 1); ++q) r.d[q] = T(0);
  return r;
}

// The input with tangent e_slot.
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> variable(T v, int slot) {
  Dual<T, N> r = constant<T, N>(v);
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = q == slot ? T(1) : T(0);
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = a.d[q] + b.d[q];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = a.d[q] - b.d[q];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = -a.d[q];
  return r;
}

// (a b)' = b' a + a' b, in the order PyTorch's forward mode adds them.
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = b.d[q] * a.v + a.d[q] * b.v;
  return r;
}

// (a / b)' = (a' - b' (a / b)) / b, by the reciprocal of b.
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
  if (N > 0) {
    const T inv = T(1) / b.v;
#pragma unroll
    for (int q = 0; q < N; ++q) r.d[q] = (a.d[q] - b.d[q] * r.v) * inv;
  }
  return r;
}

// c - a and c + a for a constant c.
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> rsub(T c, const Dual<T, N>& a) {
  return constant<T, N>(c) - a;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> radd(T c, const Dual<T, N>& a) {
  return constant<T, N>(c) + a;
}

// sqrt(a)' = a' / (2 sqrt(a))
template <typename T, int N>
__device__ __forceinline__ Dual<T, N> sqrt_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sqrt_(a.v);
  if (N > 0) {
    const T inv = T(1) / (r.v + r.v);
#pragma unroll
    for (int q = 0; q < N; ++q) r.d[q] = a.d[q] * inv;
  }
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> sin_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = sin_(a.v);
  const T c = N > 0 ? cos_(a.v) : T(0);
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = a.d[q] * c;
  return r;
}

template <typename T, int N>
__device__ __forceinline__ Dual<T, N> cos_(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = cos_(a.v);
  const T s = N > 0 ? -sin_(a.v) : T(0);
#pragma unroll
  for (int q = 0; q < N; ++q) r.d[q] = a.d[q] * s;
  return r;
}

// The rotation's tangents (angle-axis 0..2, point 3..5) in the projection's
// slots (angle-axis 0..2, point 6..8); the translation's slots 3..5 are 0.
template <typename T, int P, int R>
__device__ __forceinline__ Dual<T, P> from_rotation(const Dual<T, R>& a) {
  Dual<T, P> r = constant<T, P>(a.v);
#pragma unroll
  for (int q = 0; q < R; ++q) r.d[q < 3 ? q : q + 3] = a.d[q];
  return r;
}

// The projection's 9 tangents as the first 9 of 12 (f, k1, k2 are 0).
template <typename T, int F, int P>
__device__ __forceinline__ Dual<T, F> extend(const Dual<T, P>& a) {
  Dual<T, F> r = constant<T, F>(a.v);
#pragma unroll
  for (int q = 0; q < P; ++q) r.d[q] = a.d[q];
  return r;
}

template <typename T, int N>
__device__ __forceinline__ void cross(const Dual<T, N> (&a)[3], const Dual<T, N> (&b)[3],
                                      Dual<T, N> (&out)[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The residual of one observation into out[0..2) and, with kJacobians, the
// Jacobian rows into out[2..26): J_cam row-major (2 x 9), then J_pt (2 x 3).
template <typename T, bool kJacobians>
__device__ __forceinline__ void snavely(const T* __restrict__ cam, const T* __restrict__ pt,
                                        T obs_x, T obs_y, T* out) {
  // Rotation: tangents 0..2 the angle-axis, 3..5 the point.
  constexpr int R = kJacobians ? 6 : 0;
  Dual<T, R> aa[3], X[3], rot[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    aa[i] = variable<T, R>(cam[i], i);
    X[i] = variable<T, R>(pt[i], 3 + i);
  }
  const Dual<T, R> theta_sq = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2];
  if (theta_sq.v < T(1e-24)) {
    // Near zero: X + aa x X, first-order exact (rotation.h:598-622).
    Dual<T, R> c[3];
    cross(aa, X, c);
#pragma unroll
    for (int i = 0; i < 3; ++i) rot[i] = X[i] + c[i];
  } else {
    const Dual<T, R> theta = sqrt_(theta_sq);
    Dual<T, R> w[3], w_cross_x[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = aa[i] / theta;
    const Dual<T, R> cos_t = cos_(theta);
    const Dual<T, R> sin_t = sin_(theta);
    cross(w, X, w_cross_x);
    const Dual<T, R> w_dot_x = w[0] * X[0] + w[1] * X[1] + w[2] * X[2];
    const Dual<T, R> k = w_dot_x * rsub(T(1), cos_t);
#pragma unroll
    for (int i = 0; i < 3; ++i) rot[i] = X[i] * cos_t + w_cross_x[i] * sin_t + w[i] * k;
  }

  // Projection: tangents 0..2 the angle-axis, 3..5 the translation, 6..8
  // the point.
  constexpr int P = kJacobians ? 9 : 0;
  Dual<T, P> p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = from_rotation<T, P, R>(rot[i]) + variable<T, P>(cam[3 + i], 3 + i);
  }
  const Dual<T, P> xp = -p[0] / p[2];
  const Dual<T, P> yp = -p[1] / p[2];
  const Dual<T, P> r2 = xp * xp + yp * yp;

  // Distortion and focal length: tangents 0..8 as above, 9 the focal
  // length, 10 and 11 k1 and k2.
  constexpr int F = kJacobians ? 12 : 0;
  const Dual<T, F> r2f = extend<T, F, P>(r2);
  const Dual<T, F> xf = extend<T, F, P>(xp);
  const Dual<T, F> yf = extend<T, F, P>(yp);
  const Dual<T, F> focal = variable<T, F>(cam[6], 9);
  const Dual<T, F> k1 = variable<T, F>(cam[7], 10);
  const Dual<T, F> k2 = variable<T, F>(cam[8], 11);
  const Dual<T, F> distortion = radd(T(1), r2f * (k1 + k2 * r2f));
  const Dual<T, F> scale = focal * distortion;
  const Dual<T, F> px = scale * xf;
  const Dual<T, F> py = scale * yf;
  out[0] = px.v - obs_x;
  out[1] = py.v - obs_y;
  if constexpr (kJacobians) {
    // J_cam columns: angle-axis, translation, f, k1, k2; J_pt: the point.
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      out[2 + c] = px.d[c < 6 ? c : c + 3];
      out[11 + c] = py.d[c < 6 ? c : c + 3];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out[20 + c] = px.d[6 + c];
      out[23 + c] = py.d[6 + c];
    }
  }
}

template <typename T, bool kJacobians>
__global__ void __launch_bounds__(kThreads)
    evaluate_kernel(const T* __restrict__ cameras, const T* __restrict__ points,
                    const int64_t* __restrict__ cam_rows, const int64_t* __restrict__ pt_rows,
                    const T* __restrict__ observed, T* __restrict__ residuals,
                    T* __restrict__ j_cam, T* __restrict__ j_pt, int64_t n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int64_t i = base + threadIdx.x;
  T out[kOut];
  if (i < n) {
    const T* cam = cameras + cam_rows[i] * 9;
    const T* pt = points + pt_rows[i] * 3;
    snavely<T, kJacobians>(cam, pt, observed[2 * i], observed[2 * i + 1], out);
  }
  if constexpr (!kJacobians) {
    if (i < n) {
      residuals[2 * i] = out[0];
      residuals[2 * i + 1] = out[1];
    }
  } else {
    __shared__ T stage[kThreads * kStride];
    if (i < n) {
#pragma unroll
      for (int k = 0; k < kOut; ++k) stage[threadIdx.x * kStride + k] = out[k];
    }
    __syncthreads();
    const int count = static_cast<int>(n - base < kThreads ? n - base : kThreads);
    for (int f = threadIdx.x; f < count * 2; f += kThreads) {
      residuals[base * 2 + f] = stage[(f >> 1) * kStride + (f & 1)];
    }
    for (int f = threadIdx.x; f < count * 18; f += kThreads) {
      const int row = f / 18;
      j_cam[base * 18 + f] = stage[row * kStride + 2 + (f - row * 18)];
    }
    for (int f = threadIdx.x; f < count * 6; f += kThreads) {
      const int row = f / 6;
      j_pt[base * 6 + f] = stage[row * kStride + 20 + (f - row * 6)];
    }
  }
}

template <typename T>
int launch(const void* cameras, const void* points, const void* cam_rows,
           const void* pt_rows, const void* observed, void* residuals, void* j_cam,
           void* j_pt, int64_t n, int jacobians, void* stream_v) {
  if (n == 0) return 0;  // nothing to launch (an empty output has no storage)
  if (n < 0 || (jacobians && (j_cam == nullptr || j_pt == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int grid = static_cast<unsigned int>(blocks);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const T* c = static_cast<const T*>(cameras);
  const T* p = static_cast<const T*>(points);
  const int64_t* ci = static_cast<const int64_t*>(cam_rows);
  const int64_t* pi = static_cast<const int64_t*>(pt_rows);
  const T* o = static_cast<const T*>(observed);
  T* r = static_cast<T*>(residuals);
  if (jacobians) {
    evaluate_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        c, p, ci, pi, o, r, static_cast<T*>(j_cam), static_cast<T*>(j_pt), n);
  } else {
    evaluate_kernel<T, false><<<grid, kThreads, 0, stream>>>(c, p, ci, pi, o, r, nullptr,
                                                             nullptr, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes. Pointers are device pointers: the (C, 9)
// camera and (P, 3) point tables, the (B,) int64 rows of each observation
// in them, the (B, 2) observed values, and the outputs r (B, 2), J_cam
// (B, 2, 9) and J_pt (B, 2, 3), all contiguous (the Jacobians' null and
// unwritten where `jacobians` is 0). `stream` is a cudaStream_t. Returns
// the cudaError_t of the launch (0 = success).
extern "C" int snavely_evaluate_f32(const void* cameras, const void* points,
                                    const void* cam_rows, const void* pt_rows,
                                    const void* observed, void* residuals, void* j_cam,
                                    void* j_pt, int64_t n, int jacobians, void* stream) {
  return launch<float>(cameras, points, cam_rows, pt_rows, observed, residuals, j_cam, j_pt,
                       n, jacobians, stream);
}

extern "C" int snavely_evaluate_f64(const void* cameras, const void* points,
                                    const void* cam_rows, const void* pt_rows,
                                    const void* observed, void* residuals, void* j_cam,
                                    void* j_pt, int64_t n, int jacobians, void* stream) {
  return launch<double>(cameras, points, cam_rows, pt_rows, observed, residuals, j_cam, j_pt,
                        n, jacobians, stream);
}
