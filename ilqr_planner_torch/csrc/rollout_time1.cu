// Whole-trajectory closed-loop trial rollout of the time-optimal first-order
// kind, one CUDA thread per scenario lane, for Hopper (sm_90a).
//
// Replaces ilqr_planner_tpu/ops/pallas_kernels/rollout_time1.py::
// rollout_time1_pallas / rollout_from_steps. Per step t (0 .. H-2), with the
// state x (n = m = dof + 1: joint angles and the continuous time) carried in
// registers:
//   du = K_t (x - xo_t) + alpha d_t,   u = uo_t + du,
//   s = u[m-1],  q' = q + s^2 u_q,  t' = t + s^2,
// and x', u and ||du||^2 are written out. The caller assembles the trial's
// cost from the returned trajectory.
//
// What bounds it on the H100: bytes. Each step reads the m x n gains, d, xo
// and uo and writes x', u and ||du||^2, about 105 values a lane at n = 8,
// for some 2 n m + 6 m operations: far below the arithmetic peak.
//
// What this design does about it: one thread per lane and every array with
// the lane axis minor, so each warp's load or store of one entry is one
// coalesced 128-byte line (f32); each input is read exactly once, in place
// (no packing copy of the gains per backward pass, unlike the TPU kernel's
// input slab). Blocks are 32 threads so that the time-optimal batch
// (B = 2048) spreads over 64 SMs rather than 16 of the 132. The per-lane
// recursion is serial over the horizon, so with one warp per SM the loads of
// a step are latency-bound; more lanes in flight per SM (several steps'
// loads issued ahead) are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <int N, typename T>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(const T* __restrict__ Ks, const T* __restrict__ ds,
               const T* __restrict__ Xref, const T* __restrict__ Uref,
               const T* __restrict__ x0, T alpha, T* __restrict__ X,
               T* __restrict__ U, T* __restrict__ du2, int Hm1, int B) {
  constexpr int M = N;
  constexpr int DOF = N - 1;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  T x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    x[i] = x0[i * sB + b];
    X[i * sB + b] = x[i];
  }

#pragma unroll 1
  for (int t = 0; t < Hm1; ++t) {
    const size_t rowN = static_cast<size_t>(t) * N * sB + b;  // [t, 0, b]
    const size_t rowM = static_cast<size_t>(t) * M * sB + b;
    const T* const K = Ks + static_cast<size_t>(t) * M * N * sB + b;
    T diff[N];
#pragma unroll
    for (int j = 0; j < N; ++j) diff[j] = x[j] - Xref[rowN + j * sB];
    T u[M];
    T sq = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j) acc += K[(i * N + j) * sB] * diff[j];
      const T du = acc + alpha * ds[rowM + i * sB];
      sq += du * du;
      u[i] = Uref[rowM + i * sB] + du;
      U[rowM + i * sB] = u[i];
    }
    const T dtk = u[M - 1] * u[M - 1];
#pragma unroll
    for (int i = 0; i < DOF; ++i) x[i] = x[i] + dtk * u[i];
    x[N - 1] = x[N - 1] + dtk;
    const size_t next = rowN + N * sB;  // [t + 1, 0, b]
#pragma unroll
    for (int i = 0; i < N; ++i) X[next + i * sB] = x[i];
    du2[static_cast<size_t>(t) * sB + b] = sq;
  }
}

template <int N, typename T>
int launch(const T* Ks, const T* ds, const T* Xref, const T* Uref,
           const T* x0, T alpha, T* X, T* U, T* du2, int Hm1, int B,
           void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  rollout_kernel<N, T><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      Ks, ds, Xref, Uref, x0, alpha, X, U, du2, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Arrays are contiguous with the lane axis
// minor: Ks [Hm1,m,n,B], ds/Uref [Hm1,m,B], Xref [Hm1+1,n,B] (rows 0..Hm1-1
// read), x0 [n,B]; out X [Hm1+1,n,B] (row 0 = x0), U [Hm1,m,B],
// du2 [Hm1,B]. n = m = 8. Each returns the CUDA error code of the launch.
#define ROLLOUT_ENTRY(NAME, N, T)                                             \
  extern "C" int NAME(const T* Ks, const T* ds, const T* Xref, const T* Uref, \
                      const T* x0, T alpha, T* X, T* U, T* du2, int Hm1,      \
                      int B, void* stream) {                                  \
    return launch<N, T>(Ks, ds, Xref, Uref, x0, alpha, X, U, du2, Hm1, B,     \
                        stream);                                              \
  }

ROLLOUT_ENTRY(rollout_time1_f32, 8, float)
ROLLOUT_ENTRY(rollout_time1_f64, 8, double)
