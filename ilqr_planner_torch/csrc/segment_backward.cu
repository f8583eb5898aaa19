// Whole-sweep first-order backward (Riccati) pass of the lane-major fleet
// solver, for Hopper (sm_90a), at any chain width n (SB_N, one library a
// width, built at first use).
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
// What bounds it on the H100: by its bytes, memory. Per lane and step it
// reads 3n values (l2, lx, u) and writes n(n+1) (K, d): 77 values, 308
// bytes in float32 at n = 7, so 99 steps x 36864 lanes move about 1.12 GB,
// 0.34 ms at 3.35 TB/s. The arithmetic, about 1.7 kFLOP a step, is about
// 6 GFLOP, 0.09 ms at the 67 TFLOP/s float32 peak. In practice latency:
// each lane's step is a serial chain (a Cholesky factor column by column,
// two triangular solves, the value update). The first design, one thread a
// lane with the whole step in its registers at 128 lanes a block (184 / 254
// registers), took 0.82 / 1.27 ms at the flagship's shape on an NVIDIA H100
// 80GB HBM3 at 700 W: 288 blocks where 264 fit at once, and each step's
// rows loaded inside the chain.
//
// The design: one thread a lane, the (P, p) carry and the step's algebra
// in registers, every sum in the first design's order (the recursion
// amplifies reordered rounding). kLanes = 32 lanes a block, the registers
// bounded in float32 (kMinBlocks) so that the flagship's 36864 lanes are
// resident at once (one wave); the next step's rows (U, lx, L2) in flight
// by cp.async into a ring in shared memory that only the lane's own thread
// reads, so the kernel has no barrier at all and a thread past B leaves at
// once. Keypoint Hessians are read at their (rare) steps from device
// memory. Several threads a lane (n on block barriers, or a lane's threads
// in one warp) were measured and lost at this batch (PERF.md): they
// add barriers and shared-memory traffic to every lane's step and hold
// fewer lanes an SM, while one thread a lane already holds all the
// flagship's lanes at once and hides its chain behind the other lanes.
// Measured at the flagship's shape (n = 7, H = 100, B = 36864) on an NVIDIA
// H100 80GB HBM3 at 700 W, 168 / 253 registers, 12 / 8 blocks an SM: see
// PERF.md (tools/kernel_variants.py, ten launches back to back); the first
// design, one thread a lane at 128 lanes a block, took 0.72 / 1.17 ms there.
// Tensor cores (wgmma) are not the tool: the products are 7 x 7 a lane
// inside a serial recursion, and float32 / float64 accuracy is part of the
// result.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#ifndef SB_N
#error "build with -DSB_N=<n>"
#endif
#ifndef SB_LANES
#define SB_LANES 32
#endif
#ifndef SB_AHEAD
#define SB_AHEAD 1
#endif
#ifndef SB_MIN_BLOCKS
#define SB_MIN_BLOCKS 10
#endif

namespace {

constexpr int kLanes = SB_LANES;  // lanes (threads) a block
constexpr int kAhead = SB_AHEAD;  // steps whose rows are in flight

// values a lane keeps in shared memory: U, lx, L2 of kAhead + 1 steps
template <int N>
constexpr int kRows = 3 * N;
template <int N>
constexpr int kVals = (kAhead + 1) * kRows<N>;

// In float32 up to the arm's width: SB_MIN_BLOCKS blocks of 32 lanes an SM,
// 320 lanes, so that the flagship's 36864 lanes (280 an SM) are resident at
// once; ptxas then keeps the step within 200 registers (left to itself it
// took 168-254 by the build, and above 200 held 256 lanes an SM: a second
// wave). Wider chains and float64 (254 registers at n = 7: 256 lanes an
// SM) take what they need.
template <typename T, int N>
constexpr int kMinBlocks = sizeof(T) == 4 && N <= 7 ? SB_MIN_BLOCKS : 1;

#define SWEEP_ARGS                                                         \
  const T *__restrict__ P0, const T *__restrict__ p0,                      \
      const T *__restrict__ L2, const T *__restrict__ lx,                  \
      const T *__restrict__ U, const T *__restrict__ gxx,                  \
      const int *__restrict__ slots, const T *__restrict__ params,         \
      T *__restrict__ Ks, T *__restrict__ ds, int Hm1, int B

template <typename T, int N>
__global__ void __launch_bounds__(kLanes, (kMinBlocks<T, N>))
segment_backward_kernel(SWEEP_ARGS) {
  constexpr int kL = kLanes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = threadIdx.x;
  const int b = blockIdx.x * kL + l;
  if (b >= B) return;  // no barrier here, and a lane reads only its own rows
  const size_t sB = static_cast<size_t>(B);
  // this thread's entry e of ring slot s at ring[(s * kRows + e) * kL]
  T* const ring = reinterpret_cast<T*>(smem_raw) + l;

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

  // The rows of step s (U, lx, L2 of the lane) go to ring slot
  // s % (kAhead + 1); addresses are formed from s, not kept (in float64
  // every register counts: the carry and the step's algebra take the rest).
  auto copy_rows = [&](int s) {
    T* const dst = ring + (s % (kAhead + 1)) * kRows<N> * kL;
    const size_t src = static_cast<size_t>(s) * N * sB + b;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      __pipeline_memcpy_async(dst + i * kL, U + src + i * sB, sizeof(T));
      __pipeline_memcpy_async(dst + (N + i) * kL, lx + src + i * sB, sizeof(T));
      __pipeline_memcpy_async(dst + (2 * N + i) * kL, L2 + src + i * sB,
                              sizeof(T));
    }
  };
  for (int s = 0; s < kAhead; ++s) {
    if (Hm1 - 1 - s >= 0) copy_rows(Hm1 - 1 - s);
    __pipeline_commit();
  }

  // carry: the upper triangle of P (i <= j) and p
  T P[N][N], p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    p[i] = p0[i * sB + b];
#pragma unroll
    for (int j = i; j < N; ++j) P[i][j] = P0[(i * N + j) * sB + b];
  }

#pragma unroll 1
  for (int t = Hm1 - 1; t >= 0; --t) {
    const size_t row = static_cast<size_t>(t) * N * sB + b;  // [t, 0, b]
    const int slot = slots[t];
    if (t - kAhead >= 0) copy_rows(t - kAhead);
    __pipeline_commit();
    // this step's rows: U, lx, L2 at entries 0, N, 2N
    const T* const rows = ring + (t % (kAhead + 1)) * kRows<N> * kL;

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

    __pipeline_wait_prior(kAhead);  // this step's rows have landed
    T K[N][N], d[N], ut[N];
#pragma unroll
    for (int i = 0; i < N; ++i) ut[i] = rows[i * kL];
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
        if (i == j) acc += rows[(2 * N + i) * kL];
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
      p[i] = rows[(N + i) * kL] - (r[i] * ut[i] + rr[i] * d[i]) * inv_dt - reg * s;
    }
#undef MINV
  }
}

#undef SWEEP_ARGS

template <typename T>
constexpr int smem_bytes() {
  return static_cast<int>(kVals<SB_N> * kLanes * sizeof(T));
}

template <typename T>
int launch(const T* P0, const T* p0, const T* L2, const T* lx, const T* U,
           const T* gxx, const int* slots, const T* params, T* Ks, T* ds,
           int Hm1, int B, void* stream) {
  const auto kernel = segment_backward_kernel<T, SB_N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + kLanes - 1) / kLanes, kLanes, smem_bytes<T>(),
           static_cast<cudaStream_t>(stream)>>>(P0, p0, L2, lx, U, gxx, slots,
                                                params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, threads a block, dynamic shared memory, blocks the card holds on
// one SM) of a launch at batch B
template <typename T>
int geometry(int B, int* out) {
  const auto kernel = segment_backward_kernel<T, SB_N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (B + kLanes - 1) / kLanes;
  out[1] = kLanes;
  out[2] = smem_bytes<T>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], kernel, kLanes, smem_bytes<T>()));
}

}  // namespace

// Plain C entry points for ctypes, segment_backward_n<n>_<type> for this
// library's width n = SB_N. Arrays are contiguous with the lane axis minor:
// P0 [n,n,B], p0 [n,B], L2/lx/U [Hm1,n,B], gxx [n_kp,n,n,B] (upper
// triangle read), slots [Hm1] (-1 off keypoints), params [2+n] =
// (dt, reg, Rt); out Ks [Hm1,n,n,B], ds [Hm1,n,B]. Each returns the CUDA
// error code of the launch.
#define SB_ENTRY(N, T, TAG)                                                   \
  extern "C" int segment_backward_n##N##_##TAG(                               \
      const T* P0, const T* p0, const T* L2, const T* lx, const T* U,         \
      const T* gxx, const int* slots, const T* params, T* Ks, T* ds,          \
      int Hm1, int B, void* stream) {                                         \
    return launch<T>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B,   \
                     stream);                                                 \
  }
// one more level, so that SB_N expands before ## pastes
#define SB_ENTRY_OF(N, T, TAG) SB_ENTRY(N, T, TAG)

SB_ENTRY_OF(SB_N, float, f32)
SB_ENTRY_OF(SB_N, double, f64)

// The launch geometry of width n at batch B for an element of `itemsize`
// bytes (4 or 8) -> out[4] = (blocks, threads a block, dynamic shared
// memory in bytes, resident blocks an SM by the CUDA occupancy calculator).
// Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a width that is
// not this library's.
extern "C" int segment_backward_geometry(int n, int itemsize, int B, int* out) {
  if (n != SB_N) return 1;
  return itemsize == 4 ? geometry<float>(B, out) : geometry<double>(B, out);
}
