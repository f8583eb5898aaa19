// Whole-sweep backward (Riccati) pass of the lane-major fleet solver for the
// double integrator and for the sqrt-dt time-optimal first-order kind, one
// CUDA thread per scenario lane, for Hopper (sm_90a).
//
// Replaces ilqr_planner_tpu/ops/pallas_kernels/segment_backward_2nd.py::
// segment_backward_pallas_2nd (kind 'second') and
// segment_backward_pallas_time1 (kind 'time1'), whose bodies are the fleet
// solver's _q_terms + _gains_value. Per step t (from H-2 down to 0), with
// the cost-to-go (P, p) carried from step t+1:
//   second (n = 2m, A = I + dt E, B = [dt^2/2 I; dt I]):
//     PA  = P A                      (dt * q-columns added to dq-columns)
//     Qux = B^T PA,  Quu = B^T P B + diag(Rt),  Qu = Rt u + B^T p
//     Qx  = lx + A^T p,  Qxx = stage + A^T PA
//   time1 (n = m = dof + 1, A = I, B = [[s^2 I, 2 s dq_cmd], [0, 2 s]],
//          s = u[m-1], so B is read from the streamed control):
//     Qux = B^T P,  Quu = B^T P B + diag(Rt),  Qu = Rt u + B^T p
//     Qx  = lx + p,  Qxx = P + stage
//   stage = diag(l2) [+ the dense keypoint Hessian gxx at a keypoint step]
// then a Gauss-Jordan solve without pivoting (the JAX package's elimination
// order) of (Quu + reg I) [S | s] = [Qux | Qu], K = -S, d = -s, and the
// collapsed value update
//   P1 = Qxx + Qux^T K - reg K^T K   (upper triangle)
//   p1 = Qx + Qux^T d - reg K^T d.
//
// What bounds it on the H100: by its bytes, memory (each step streams
// 2n + m values in and m(n+1) out a lane); but each lane's recursion is a
// serial chain of about 3 kFLOP a step ('second') with only B threads in
// flight (B = 4096: one warp per SM), so latency, not the 3.35 TB/s, is what
// this first design meets in practice.
//
// What this first design does about it: one thread per lane, every array
// with the lane axis minor, so a warp's loads and stores are coalesced. The
// per-lane working set (two ping-pong copies of the symmetric (P, p) carry,
// the m x m system and the m x (n+1) right-hand side: 392 values at n = 14,
// 224 at n = 8) does not fit in registers, so it lives in shared memory
// laid out [entry][thread] (conflict-free for float: neighbouring threads,
// neighbouring words). Blocks are 32 threads (50 KB of shared memory for
// 'second' in float32, 100 KB in float64, opted in above the 48 KB
// default), so B = 2048 lanes still give 64 SMs work and B = 4096 give 128. Qux is not kept after the elimination: its column
// is recomputed from the old carry where the value update needs it. The
// keypoint Hessians are read only at steps whose slot is not -1, upper
// triangle only. Register and shared-memory tiling across threads of one
// lane, TMA and tensor cores are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;
enum { kSecond = 0, kTime1 = 1 };

// index of (i, j), i <= j, in a row-major upper triangle of an N x N matrix
template <int N>
__device__ __forceinline__ int tri(int i, int j) {
  return i * N - (i * (i - 1)) / 2 + (j - i);
}

template <int N>
__device__ __forceinline__ int sym(int i, int j) {
  return i <= j ? tri<N>(i, j) : tri<N>(j, i);
}

template <int N, int M>
struct Layout {
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kCarry = kTri + N;           // P upper triangle, p
  static constexpr int kVals = 2 * kCarry + M * M + M * (N + 1);
};

template <int KIND, int N, int M, typename T>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const T* __restrict__ P0, const T* __restrict__ p0,
             const T* __restrict__ L2, const T* __restrict__ lx,
             const T* __restrict__ U, const T* __restrict__ gxx,
             const int* __restrict__ slots, const T* __restrict__ params,
             T* __restrict__ Ks, T* __restrict__ ds, int Hm1, int B) {
  constexpr int DOF = KIND == kSecond ? M : M - 1;
  constexpr int TRI = Layout<N, M>::kTri;
  constexpr int CARRY = Layout<N, M>::kCarry;
  constexpr int NX = N + 1;  // columns of the right-hand side [Qux | Qu]
  static_assert(KIND != kSecond || N == 2 * M, "second: n == 2m");
  static_assert(KIND != kTime1 || N == M, "time1: n == m");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kThreads + tid;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  // this thread's entry e of a shared buffer lives at base[e * kThreads]
  T* const lane = smem + tid;
  T* cur = lane;                          // carry of step t + 1
  T* nxt = lane + CARRY * kThreads;       // carry being written
  T* const Ash = lane + 2 * CARRY * kThreads;
  T* const Xsh = Ash + M * M * kThreads;
#define SH(base, e) (base)[(e) * kThreads]
#define A_(i, j) SH(Ash, (i) * M + (j))
#define X_(i, j) SH(Xsh, (i) * NX + (j))

  const T dt = params[0];
  const T b1 = params[1];  // dt^2 / 2, rounded once from double
  const T reg = params[2];
  T Rt[M];
#pragma unroll
  for (int i = 0; i < M; ++i) Rt[i] = params[3 + i];

  for (int i = 0; i < N; ++i) {
    SH(cur, TRI + i) = p0[i * sB + b];
    for (int j = i; j < N; ++j)
      SH(cur, tri<N>(i, j)) = P0[(i * N + j) * sB + b];
  }

#pragma unroll 1
  for (int t = Hm1 - 1; t >= 0; --t) {
    const size_t rowN = static_cast<size_t>(t) * N * sB + b;  // [t, 0, b]
    const size_t rowM = static_cast<size_t>(t) * M * sB + b;
    const int slot = slots[t];
    const T* const g_slot =
        slot >= 0 ? gxx + static_cast<size_t>(slot) * N * N * sB + b : nullptr;

    auto P = [&](int i, int j) -> T { return SH(cur, sym<N>(i, j)); };
    auto pv = [&](int i) -> T { return SH(cur, TRI + i); };
    T u[M];
#pragma unroll
    for (int i = 0; i < M; ++i) u[i] = U[rowM + i * sB];

    // kind constants: 'time1' reads its B from the control
    T dtk = T(0), h = T(0), g[DOF > 0 ? DOF : 1];
    if (KIND == kTime1) {
      const T s = u[M - 1];
      dtk = s * s;
      h = T(2) * s;
#pragma unroll
      for (int i = 0; i < DOF; ++i) g[i] = h * u[i];
    }

    // PA = P A and the rows of Qux = B^T P A, column c
    auto PA = [&](int a, int c) -> T {
      return c < DOF || KIND == kTime1 ? P(a, c) : P(a, c) + dt * P(a, c - DOF);
    };
    auto qux = [&](int r, int c) -> T {
      if (KIND == kSecond) return b1 * PA(r, c) + dt * PA(r + DOF, c);
      if (r < DOF) return dtk * P(r, c);
      T s = T(0);
#pragma unroll
      for (int q = 0; q < DOF; ++q) s += g[q] * P(q, c);
      return s + h * P(N - 1, c);
    };

    // 1. the system [Quu + reg I | Qux | Qu]
    if (KIND == kSecond) {
#pragma unroll 1
      for (int i = 0; i < M; ++i) {
        for (int j = 0; j < M; ++j) {
          const T pb_i = b1 * P(i, j) + dt * P(i, j + DOF);
          const T pb_di = b1 * P(i + DOF, j) + dt * P(i + DOF, j + DOF);
          T q = b1 * pb_i + dt * pb_di;
          if (i == j) q = q + Rt[i] + reg;
          A_(i, j) = q;
        }
        X_(i, N) = Rt[i] * u[i] + (b1 * pv(i) + dt * pv(i + DOF));
      }
    } else {
      // PB's last column: P g-column plus h P[:, n-1]
      T pbl[N];
#pragma unroll
      for (int a = 0; a < N; ++a) {
        T s = T(0);
#pragma unroll
        for (int q = 0; q < DOF; ++q) s += P(a, q) * g[q];
        pbl[a] = s + P(a, N - 1) * h;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        // Quu[i][j] = dtk PB[i][j] (i < dof), and the chain-rule row
        T s = T(0);
#pragma unroll
        for (int q = 0; q < DOF; ++q)
          s += g[q] * (j < DOF ? dtk * P(q, j) : pbl[q]);
        T last = s + h * (j < DOF ? dtk * P(N - 1, j) : pbl[N - 1]);
#pragma unroll
        for (int i = 0; i < DOF; ++i) {
          T q = dtk * (j < DOF ? dtk * P(i, j) : pbl[i]);
          if (i == j) q = q + Rt[i] + reg;
          A_(i, j) = q;
        }
        if (j == DOF) last = last + Rt[DOF] + reg;
        A_(DOF, j) = last;
      }
      T s = T(0);
#pragma unroll
      for (int q = 0; q < DOF; ++q) s += g[q] * pv(q);
#pragma unroll
      for (int i = 0; i < DOF; ++i) X_(i, N) = Rt[i] * u[i] + dtk * pv(i);
      X_(DOF, N) = Rt[DOF] * u[DOF] + (s + h * pv(N - 1));
    }
#pragma unroll 1
    for (int c = 0; c < N; ++c) {
#pragma unroll
      for (int r = 0; r < M; ++r) X_(r, c) = qux(r, c);
    }

    // 2. Gauss-Jordan without pivoting: [I | S | s]
#pragma unroll 1
    for (int k = 0; k < M; ++k) {
      const T piv = T(1) / A_(k, k);
      for (int j = k + 1; j < M; ++j) A_(k, j) = A_(k, j) * piv;
#pragma unroll
      for (int c = 0; c < NX; ++c) X_(k, c) = X_(k, c) * piv;
#pragma unroll 1
      for (int r = 0; r < M; ++r) {
        if (r == k) continue;
        const T fac = A_(r, k);
        for (int j = k + 1; j < M; ++j) A_(r, j) = A_(r, j) - fac * A_(k, j);
#pragma unroll
        for (int c = 0; c < NX; ++c) X_(r, c) = X_(r, c) - fac * X_(k, c);
      }
    }

    // 3. gains out: K = -S, d = -s
    T d[M];
#pragma unroll
    for (int r = 0; r < M; ++r) {
      d[r] = -X_(r, N);
      ds[rowM + r * sB] = d[r];
    }
#pragma unroll 1
    for (int r = 0; r < M; ++r) {
      T* const Kr = Ks + (static_cast<size_t>(t) * M + r) * N * sB + b;
      for (int c = 0; c < N; ++c) Kr[c * sB] = -X_(r, c);
    }

    // 4. value update into the other carry buffer
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      T qc[M], kc[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        qc[r] = qux(r, i);
        kc[r] = -X_(r, i);
      }
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        s1 += qc[r] * d[r];
        s2 += kc[r] * d[r];
      }
      T qx = lx[rowN + i * sB];
      if (KIND == kSecond)
        qx = qx + (i < DOF ? pv(i) : pv(i) + dt * pv(i - DOF));
      else
        qx = qx + pv(i);
      SH(nxt, TRI + i) = (qx + s1) - reg * s2;

      const T l2i = L2[rowN + i * sB];
      for (int j = i; j < N; ++j) {
        T a1 = T(0), a2 = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const T kj = -X_(r, j);
          a1 += qc[r] * kj;
          a2 += kc[r] * kj;
        }
        T stage = i == j ? l2i : T(0);
        if (g_slot) stage = stage + g_slot[(i * N + j) * sB];
        T qxx;
        if (KIND == kSecond)
          qxx = stage + (i < DOF ? PA(i, j) : PA(i, j) + dt * PA(i - DOF, j));
        else
          qxx = P(i, j) + stage;
        SH(nxt, tri<N>(i, j)) = (qxx + a1) - reg * a2;
      }
    }
    T* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#undef SH
#undef A_
#undef X_
}

template <int KIND, int N, int M, typename T>
int launch(const T* P0, const T* p0, const T* L2, const T* lx, const T* U,
           const T* gxx, const int* slots, const T* params, T* Ks, T* ds,
           int Hm1, int B, void* stream) {
  const int smem =
      static_cast<int>(Layout<N, M>::kVals * kThreads * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<KIND, N, M, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  sweep_kernel<KIND, N, M, T><<<blocks, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Arrays are contiguous with the lane axis
// minor: P0 [n,n,B], p0 [n,B], L2/lx [Hm1,n,B], U [Hm1,m,B],
// gxx [n_kp,n,n,B] (upper triangle read), slots [Hm1] (-1 off keypoints),
// params [3+m] = (dt, dt^2/2, reg, Rt); out Ks [Hm1,m,n,B], ds [Hm1,m,B].
// 'second' at n = 14, m = 7; 'time1' at n = m = 8 (dt unused). Each returns
// the CUDA error code of the launch.
#define SWEEP_ENTRY(NAME, KIND, N, M, T)                                      \
  extern "C" int NAME(const T* P0, const T* p0, const T* L2, const T* lx,     \
                      const T* U, const T* gxx, const int* slots,             \
                      const T* params, T* Ks, T* ds, int Hm1, int B,          \
                      void* stream) {                                         \
    return launch<KIND, N, M, T>(P0, p0, L2, lx, U, gxx, slots, params, Ks,   \
                                 ds, Hm1, B, stream);                         \
  }

SWEEP_ENTRY(segment_backward_second_f32, kSecond, 14, 7, float)
SWEEP_ENTRY(segment_backward_second_f64, kSecond, 14, 7, double)
SWEEP_ENTRY(segment_backward_time1_f32, kTime1, 8, 8, float)
SWEEP_ENTRY(segment_backward_time1_f64, kTime1, 8, 8, double)
