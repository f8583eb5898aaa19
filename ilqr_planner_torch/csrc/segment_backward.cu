// Whole-sweep first-order backward (Riccati) pass of the lane-major fleet
// solver, one CUDA thread per scenario lane, for Hopper (sm_90a).
//
// Replaces ilqr_planner_tpu/ops/pallas_kernels/segment_backward.py::
// segment_backward_pallas. Same math: the collapsed first-order LTI
// recursion (A = I, B = dt I, m = n) with M = dt^2 P + diag(Rt + reg),
//   K  = (M^-1 diag(rr) - I) / dt
//   d  = -M^-1 (Rt u + dt p)
//   P1 = (diag(rr) - diag(rr) M^-1 diag(rr)) / dt^2 - reg K^T K
//        + diag(l2) [+ gxx at a keypoint step]
//   p1 = lx - (Rt u + diag(rr) d) / dt - reg K^T d
// M^-1 from the Cholesky factor of M: L^-1 column by column, then L^T x = y
// for the lower triangle, mirrored. P1 adds the limit diagonal first and
// the dense keypoint Hessian second, the order of the JAX kernel.
//
// What bounds it on the H100: memory. Per lane and step it reads 3n values
// (l2, lx, u) and writes n(n+1) (K, d): 77 values, 308 bytes in float32, so
// 99 steps x 36864 lanes move about 1.12 GB, 0.34 ms at 3.35 TB/s. The
// arithmetic, about 1.7 kFLOP a step, is about 6 GFLOP for the same sweep,
// 0.09 ms at the 67 TFLOP/s float32 peak.
//
// What this first design does about it: the (P, p) cost-to-go carry (28
// symmetric entries + 7 at n = 7) stays in registers for all H-1 steps, so
// only the streamed inputs and the gains touch device memory, each once.
// Lane b is thread b and every array keeps the lane axis minor ([.., B]), so
// each load and store of a warp is one coalesced 128-byte line. The
// keypoint Hessians are read only at the steps whose slot is not -1.
// Register pressure (L, L^-1, M^-1, K beside the carry) is the known cost;
// storage is reused where the recursion allows, and shared memory staging,
// TMA and tensor cores are left to later work.

#include <cuda_runtime.h>

namespace {

template <typename T, int N>
__global__ void __launch_bounds__(128)
segment_backward_kernel(const T* __restrict__ P0, const T* __restrict__ p0,
                        const T* __restrict__ L2, const T* __restrict__ lx,
                        const T* __restrict__ U, const T* __restrict__ gxx,
                        const int* __restrict__ slots,
                        const T* __restrict__ params, T* __restrict__ Ks,
                        T* __restrict__ ds, int Hm1, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  const T dt = params[0];
  const T reg = params[1];
  T r[N], rr[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = params[2 + i];
    rr[i] = r[i] + reg;
  }
  const T dt2 = dt * dt;
  const T inv_dt = T(1) / dt;
  const T inv_dt2 = inv_dt * inv_dt;

  // carry: the upper triangle of P (i <= j) and p
  T P[N][N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = p0[i * sB + b];
#pragma unroll
    for (int j = i; j < N; ++j) P[i][j] = P0[(i * N + j) * sB + b];
  }

  for (int t = Hm1 - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * N * sB + b;  // [t, 0, b]
    const int slot = slots[t];

    // Cholesky M = L L^T; Li holds 1 / L[j][j], L the strict lower part
    T L[N][N], Li[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < j; ++k) s += L[j][k] * L[j][k];
      Li[j] = T(1) / sqrt(dt2 * P[j][j] + rr[j] - s);
#pragma unroll
      for (int i = j + 1; i < N; ++i) {
        T s2 = T(0);
#pragma unroll
        for (int k = 0; k < j; ++k) s2 += L[i][k] * L[j][k];
        L[i][j] = (dt2 * P[j][i] - s2) * Li[j];
      }
    }

    // M^-1, lower triangle: per column c, y = L^-1 e_c, then L^T x = y
    T Mi[N][N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T y[N];
      y[c] = Li[c];
#pragma unroll
      for (int i = c + 1; i < N; ++i) {
        T s = T(0);
#pragma unroll
        for (int k = c; k < i; ++k) s += L[i][k] * y[k];
        y[i] = -s * Li[i];
      }
#pragma unroll
      for (int i = N - 1; i >= c; --i) {
        T s = T(0);
#pragma unroll
        for (int k = i + 1; k < N; ++k) s += L[k][i] * Mi[k][c];
        Mi[i][c] = (y[i] - s) * Li[i];
      }
    }
#define MINV(i, j) ((i) >= (j) ? Mi[i][j] : Mi[j][i])

    T K[N][N], d[N], ut[N];
#pragma unroll
    for (int i = 0; i < N; ++i) ut[i] = U[row + i * sB];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) s += MINV(i, k) * (r[k] * ut[k] + dt * p[k]);
      d[i] = -s;
      ds[row + i * sB] = d[i];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        K[i][j] = (MINV(i, j) * rr[j] - (i == j ? T(1) : T(0))) * inv_dt;
        Ks[(static_cast<size_t>(t) * N + i) * N * sB + j * sB + b] = K[i][j];
      }
    }

    // value update: P1 (upper triangle), p1
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = i; j < N; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < N; ++k) s += K[k][i] * K[k][j];
        T acc = ((i == j ? rr[i] : T(0)) - rr[i] * MINV(i, j) * rr[j]) * inv_dt2
                - reg * s;
        if (i == j) acc += L2[row + i * sB];
        if (slot >= 0)
          acc += gxx[((static_cast<size_t>(slot) * N + i) * N + j) * sB + b];
        P[i][j] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) s += K[k][i] * d[k];
      p[i] = lx[row + i * sB] - (r[i] * ut[i] + rr[i] * d[i]) * inv_dt - reg * s;
    }
#undef MINV
  }
}

template <typename T>
int launch(const T* P0, const T* p0, const T* L2, const T* lx, const T* U,
           const T* gxx, const int* slots, const T* params, T* Ks, T* ds,
           int Hm1, int B, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  segment_backward_kernel<T, 7><<<blocks, threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes; n = 7. Arrays are contiguous with the
// lane axis minor: P0 [n,n,B], p0 [n,B], L2/lx/U [Hm1,n,B],
// gxx [n_kp,n,n,B], slots [Hm1] (-1 off keypoints), params [2+n] =
// (dt, reg, Rt); out Ks [Hm1,n,n,B], ds [Hm1,n,B]. Returns cudaGetLastError().
extern "C" int segment_backward_f32(const float* P0, const float* p0,
                                    const float* L2, const float* lx,
                                    const float* U, const float* gxx,
                                    const int* slots, const float* params,
                                    float* Ks, float* ds, int Hm1, int B,
                                    void* stream) {
  return launch<float>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B,
                       stream);
}

extern "C" int segment_backward_f64(const double* P0, const double* p0,
                                    const double* L2, const double* lx,
                                    const double* U, const double* gxx,
                                    const int* slots, const double* params,
                                    double* Ks, double* ds, int Hm1, int B,
                                    void* stream) {
  return launch<double>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B,
                        stream);
}
