// Whole-trajectory closed-loop trial rollout of the time-optimal first-order
// kind for Hopper (sm_90a): n threads a scenario lane, the inputs of the
// next steps in flight through a cp.async ring in shared memory.
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
// and uo (88 values a lane at n = 8) and writes x', u and ||du||^2 (17), for
// some 2 n m + 6 m operations: far below the arithmetic peak. None of the 88
// loads depends on the carried state, but the recursion over the horizon is
// serial, so a design that loads inside the step pays one trip to device
// memory a step (the first design of this kernel: one thread a lane, 5.5 us
// a step at B = 2048 on an NVIDIA H100 80GB HBM3 at 700 W).
//
// What this design does about it:
//  * Steps in flight. A block owns kLanes neighbouring lanes. The 88 rows of
//    a step, each a contiguous run of kLanes values (one 128-byte line in
//    float32), form a [88][kLanes] tile; a ring of kStages tiles in shared
//    memory is kept full by cp.async copies that every thread starts
//    kStages - 1 steps ahead of the step that reads them. Each input is
//    read from device memory exactly once, in place.
//  * Threads a lane: n. The block is n warps; warp i holds row i of the
//    gains for the block's lanes, so every global access of a warp is one
//    row piece of neighbouring lanes (coalesced), and the tile
//    [row][lane] is read without bank conflicts. Thread (i, lane) forms
//    du_i as the sum over j = 0..n-1 in the plain version's order, and the
//    threads of a lane exchange u and du through a double-buffered row in
//    shared memory: one block barrier a step. Every thread then advances
//    its own copy of the whole state (the same operations on the same
//    values, so the copies agree to the bit), and warp 0 sums ||du||^2 in
//    the order i = 0..n-1, not as a tree, so the figure the line search
//    reads is the one-thread sum.
//  * Stores stay coalesced: warp i writes row i of u and of x', warp 0 the
//    row of ||du||^2.
//  * A ragged last block: lanes past B load lane B - 1 and store nothing;
//    no thread leaves before the last barrier.
//  * What is left (0.047 ms back to back in float32, 1.8 times the bytes
//    bound; a launch alone between two events reads 0.062 ms, the host's
//    enqueue included): a ring of 2 tiles takes 0.108 ms, 3 take 0.066, 6
//    and 8 the same, and 16 lanes a block on 128 SMs the same as 32 lanes
//    on 64, so neither the depth in flight nor the SMs' share of the
//    bandwidth is the limit any more: the step's own chain (shared loads,
//    eight FMAs, a barrier, eight more loads) and its copies' addressing
//    are.
// Tensor cores are not the tool: the product is 8 x 8 a lane inside a serial
// recursion, and float32 / float64 accuracy is part of the result.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// The width n = m (the chain's DoF plus the time state), one library a
// width, built at first use.
#ifndef ROLLOUT_N
#error "build with -DROLLOUT_N=<n>"
#endif
#ifndef ROLLOUT_LANES
#define ROLLOUT_LANES 32
#endif
#ifndef ROLLOUT_STAGES
#define ROLLOUT_STAGES 6
#endif
constexpr int kLanes = ROLLOUT_LANES;    // lanes a block
constexpr int kStages = ROLLOUT_STAGES;  // step tiles in the ring

template <int N>
struct Tile {
  static constexpr int kK = 0;               // gains, row i * N + j
  static constexpr int kD = N * N;           // feed-forward d
  static constexpr int kXo = N * N + N;      // reference state
  static constexpr int kUo = N * N + 2 * N;  // reference control
  static constexpr int kRows = N * N + 3 * N;
  // the ring, then u and du of two steps
  static constexpr int kVals = kStages * kRows + 4 * N;
};

template <int N, typename T>
__global__ void __launch_bounds__(N * kLanes)
rollout_kernel(const T* __restrict__ Ks, const T* __restrict__ ds,
               const T* __restrict__ Xref, const T* __restrict__ Uref,
               const T* __restrict__ x0, T alpha, T* __restrict__ X,
               T* __restrict__ U, T* __restrict__ du2, int Hm1, int B) {
  constexpr int M = N;
  constexpr int DOF = N - 1;
  using L = Tile<N>;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x / kLanes;  // the row of K this thread owns
  const int l = threadIdx.x % kLanes;
  const int b = blockIdx.x * kLanes + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;     // the lane whose inputs are read
  const size_t sB = static_cast<size_t>(B);
  // this thread's entry (row r) of a tile lives at base[r * kLanes]
  T* const ring = reinterpret_cast<T*>(smem_raw) + l;
  T* const ush = ring + kStages * L::kRows * kLanes;   // [2][M] u
  T* const dush = ush + 2 * M * kLanes;                // [2][M] du

  // This thread's share of a step's tile: column w of the gains and entry
  // w of d, xo and uo. The source pointers start at step 0 and move on one
  // step after each copy; ring_in is the slot the next copy fills.
  const T* kp = Ks + w * sB + bl;
  const T* dp = ds + w * sB + bl;
  const T* xp = Xref + w * sB + bl;
  const T* up = Uref + w * sB + bl;
  int ring_in = 0;
  auto copy_tile = [&]() {
    T* const dst = ring + ring_in * L::kRows * kLanes;
#pragma unroll
    for (int i = 0; i < M; ++i)
      __pipeline_memcpy_async(dst + (L::kK + i * N + w) * kLanes,
                              kp + i * N * sB, sizeof(T));
    __pipeline_memcpy_async(dst + (L::kD + w) * kLanes, dp, sizeof(T));
    __pipeline_memcpy_async(dst + (L::kXo + w) * kLanes, xp, sizeof(T));
    __pipeline_memcpy_async(dst + (L::kUo + w) * kLanes, up, sizeof(T));
    kp += M * N * sB;
    dp += M * sB;
    xp += N * sB;
    up += M * sB;
    ring_in = ring_in == kStages - 1 ? 0 : ring_in + 1;
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < Hm1) copy_tile();
    __pipeline_commit();
  }

  T x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = x0[i * sB + bl];
  if (live) X[w * sB + b] = x0[w * sB + bl];

  __pipeline_wait_prior(kStages - 2);  // the tile of step 0 has landed
  __syncthreads();
  // where this thread's entry of u and x' of step 0 goes
  T* uout = U + w * sB + bl;
  T* xout = X + (N + w) * sB + bl;
  T* sqout = du2 + bl;
  int ring_out = 0;  // the slot this step reads

#pragma unroll 1
  for (int t = 0; t < Hm1; ++t) {
    const T* const tile = ring + ring_out * L::kRows * kLanes;
    ring_out = ring_out == kStages - 1 ? 0 : ring_out + 1;
    T* const uex = ush + (t & 1) * M * kLanes;
    T* const duex = dush + (t & 1) * M * kLanes;

    T acc = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc += tile[(L::kK + w * N + j) * kLanes] *
             (x[j] - tile[(L::kXo + j) * kLanes]);
    const T du = acc + alpha * tile[(L::kD + w) * kLanes];
    const T u = tile[(L::kUo + w) * kLanes] + du;
    uex[w * kLanes] = u;
    duex[w * kLanes] = du;

    // refill the slot that step t - 1 has released, then wait for this
    // thread's copies of step t + 1; the barrier publishes them and u, du
    // (the stores to device memory come after it, so it does not wait on
    // them)
    if (t + kStages - 1 < Hm1) copy_tile();
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();

    T uu[M];
#pragma unroll
    for (int i = 0; i < M; ++i) uu[i] = uex[i * kLanes];
    const T dtk = uu[M - 1] * uu[M - 1];
#pragma unroll
    for (int i = 0; i < DOF; ++i) x[i] = x[i] + dtk * uu[i];
    x[N - 1] = x[N - 1] + dtk;

    if (live) {
      T xw = x[0];
#pragma unroll
      for (int i = 1; i < N; ++i)
        if (w == i) xw = x[i];
      *uout = u;
      *xout = xw;
      if (w == 0) {
        T sq = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T dv = duex[i * kLanes];
          sq += dv * dv;
        }
        *sqout = sq;
      }
    }
    uout += M * sB;
    xout += N * sB;
    sqout += sB;
  }
}

template <int N, typename T>
constexpr int smem_bytes() {
  return static_cast<int>(Tile<N>::kVals * kLanes * sizeof(T));
}

template <int N, typename T>
int launch(const T* Ks, const T* ds, const T* Xref, const T* Uref,
           const T* x0, T alpha, T* X, T* U, T* du2, int Hm1, int B,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      rollout_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<N, T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  rollout_kernel<N, T><<<blocks, N * kLanes, smem_bytes<N, T>(),
                         static_cast<cudaStream_t>(stream)>>>(
      Ks, ds, Xref, Uref, x0, alpha, X, U, du2, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, threads a block, dynamic shared memory, blocks the card holds on
// one SM) of a launch at batch B
template <int N, typename T>
int geometry(int B, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      rollout_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<N, T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (B + kLanes - 1) / kLanes;
  out[1] = N * kLanes;
  out[2] = smem_bytes<N, T>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], rollout_kernel<N, T>, N * kLanes, smem_bytes<N, T>()));
}

}  // namespace

// Plain C entry points for ctypes, rollout_time1_n<n>_<type> for this
// library's width n = m = ROLLOUT_N. Arrays are contiguous with the lane
// axis minor: Ks [Hm1,m,n,B], ds/Uref [Hm1,m,B], Xref [Hm1+1,n,B] (rows
// 0..Hm1-1 read), x0 [n,B]; out X [Hm1+1,n,B] (row 0 = x0), U [Hm1,m,B],
// du2 [Hm1,B]. Each returns the CUDA error code of the launch.
#define ROLLOUT_ENTRY(N, T, TAG)                                              \
  extern "C" int rollout_time1_n##N##_##TAG(                                  \
      const T* Ks, const T* ds, const T* Xref, const T* Uref, const T* x0,    \
      T alpha, T* X, T* U, T* du2, int Hm1, int B, void* stream) {            \
    return launch<N, T>(Ks, ds, Xref, Uref, x0, alpha, X, U, du2, Hm1, B,     \
                        stream);                                              \
  }
// one more level, so that ROLLOUT_N expands before ## pastes
#define ROLLOUT_ENTRY_OF(N, T, TAG) ROLLOUT_ENTRY(N, T, TAG)

ROLLOUT_ENTRY_OF(ROLLOUT_N, float, f32)
ROLLOUT_ENTRY_OF(ROLLOUT_N, double, f64)

// The launch geometry of width n at batch B for an element of `itemsize`
// bytes (4 or 8) -> out[4] = (blocks, threads a block, dynamic shared
// memory in bytes, resident blocks an SM by the CUDA occupancy calculator).
// Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a width that is
// not this library's.
extern "C" int rollout_time1_geometry(int n, int itemsize, int B, int* out) {
  if (n != ROLLOUT_N) return 1;
  return itemsize == 4 ? geometry<ROLLOUT_N, float>(B, out)
                       : geometry<ROLLOUT_N, double>(B, out);
}
