// The affine trial family of the fleet solver's line search (the LTI
// kinds) in one pass for Hopper (sm_90a): m threads a scenario lane, the
// inputs of the next steps in flight through a cp.async ring in shared
// memory.
//
// No TPU kernel stands behind it: the JAX package writes the family as a
// scan of jnp operations (`ilqr_planner_tpu/solvers/fleet.py::
// _affine_family`), which XLA fuses. In the port it was a per-step loop of
// tensor ops (the twin, `ops/cuda_kernels/affine_family.py::
// affine_family_reference`): nine full-width operations a step, some 900
// launches a line search. For the first-order kind (n = m) and the double
// integrator (n = 2m, dof = m) the closed-loop trial trajectories are affine
// in alpha, X(alpha) = Xb + alpha Xd and U(alpha) = Ub + alpha Ud, and one
// pass over the horizon gives both. Per step t (0 .. H-2), with the base xb
// and the direction xd (n each) carried in registers:
//   dub = K_t (xb - xo_t),   dud = K_t xd + d_t   (K_t read once for both),
//   ub = uo_t + dub,
//   first order:       xb' = xb + dt ub,   xd' = xd + dt dud;
//   double integrator: q' = q + dt dq + dt^2/2 v,  dq' = dq + dt v
//                      (v = ub on the base, dud on the direction),
// and xb', xd', ub, dud and the ||du||^2 coefficients qa = dub.dub,
// qb = dub.dud, qc = dud.dud (each summed in the order i = 0..m-1) are
// written out. Xb[0] = x0 and Xd[0] = 0 are written here too, so a family
// is one launch.
//
// What bounds it on the H100: bytes. Each step reads the m x n gains, d, xo
// and uo (70 values a lane at n = m = 7) and writes xb', xd', ub, dud and
// the three coefficients (31), for some 4 n m operations: far below the
// arithmetic peak. The recursion over the horizon is serial, but no load
// depends on the carried state, so the design of `rollout_time1.cu` (the
// same recursion with one trajectory) applies:
//  * Steps in flight. A block owns kLanes neighbouring lanes. The rows of a
//    step, each a contiguous run of kLanes values (one 128-byte line in
//    float32), form a [rows][kLanes] tile; a ring of kStages tiles in shared
//    memory is kept full by cp.async copies that every thread starts
//    kStages - 1 steps ahead of the step that reads them. Each input is
//    read from device memory once, in place.
//  * Threads a lane: m. The block is m warps; warp i forms row i of the
//    product for the block's lanes (dub_i and dud_i, each a sum over
//    j = 0..n-1 in order), so every global access of a warp is one row
//    piece of neighbouring lanes (coalesced) and the tile [row][lane] is
//    read without bank conflicts. The threads of a lane exchange ub, dub
//    and dud through a double-buffered row in shared memory: one block
//    barrier a step. Every thread then advances its own copy of the whole
//    base and direction (the same operations on the same values, so the
//    copies agree to the bit).
//  * Stores stay coalesced: warp i writes row i of ub and dud and rows i
//    (and m + i, double integrator) of xb' and xd'; warps 0, 1, 2 (mod m)
//    write the rows of qa, qb and qc.
//  * A ragged last block: lanes past B load lane B - 1 and store nothing;
//    no thread leaves before the last barrier.
// Tensor cores are not the tool: the product is m x n a lane inside a serial
// recursion, and float32 / float64 accuracy is part of the result.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// The width: state n and control m, n = m (first order) or n = 2m (the
// double integrator), one library a width, built at first use.
#if !defined(AF_N) || !defined(AF_M)
#error "build with -DAF_N=<n> -DAF_M=<m>"
#endif
static_assert(AF_N == AF_M || AF_N == 2 * AF_M,
              "AF_N must be AF_M (first order) or 2 AF_M (double integrator)");
constexpr int kLanes = 32;  // lanes a block
constexpr int kStages = 6;  // step tiles in the ring

template <int M, bool SECOND>
struct Tile {
  static constexpr int N = SECOND ? 2 * M : M;
  static constexpr int kK = 0;                   // gains, row i * N + j
  static constexpr int kD = M * N;               // feed-forward d
  static constexpr int kXo = M * N + M;          // reference state
  static constexpr int kUo = M * N + M + N;      // reference control
  static constexpr int kRows = M * N + 2 * M + N;
  // the ring, then ub, dub and dud of two steps
  static constexpr int kVals = kStages * kRows + 6 * M;
};

template <int M, bool SECOND, typename T>
__global__ void __launch_bounds__(M * kLanes)
affine_family_kernel(const T* __restrict__ Ks, const T* __restrict__ ds,
                     const T* __restrict__ Xref, const T* __restrict__ Uref,
                     const T* __restrict__ x0, T dt, T half_dt2,
                     T* __restrict__ Xb, T* __restrict__ Xd,
                     T* __restrict__ Ub, T* __restrict__ Ud,
                     T* __restrict__ qa, T* __restrict__ qb,
                     T* __restrict__ qc, int Hm1, int B) {
  using L = Tile<M, SECOND>;
  constexpr int N = L::N;
  constexpr int C = N / M;  // state rows a thread copies and stores: 1 or 2

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x / kLanes;  // the row of K this thread owns
  const int l = threadIdx.x % kLanes;
  const int b = blockIdx.x * kLanes + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;     // the lane whose inputs are read
  const size_t sB = static_cast<size_t>(B);
  // this thread's entry (row r) of a tile lives at base[r * kLanes]
  T* const ring = reinterpret_cast<T*>(smem_raw) + l;
  T* const ubsh = ring + kStages * L::kRows * kLanes;  // [2][M] ub
  T* const dbsh = ubsh + 2 * M * kLanes;               // [2][M] dub
  T* const ddsh = dbsh + 2 * M * kLanes;               // [2][M] dud

  // This thread's share of a step's tile: columns w + c m of the gains and
  // entries w + c m of xo (c < C), entry w of d and uo. The source pointers
  // start at step 0 and move on one step after each copy; ring_in is the
  // slot the next copy fills.
  const T* kp = Ks + w * sB + bl;
  const T* dp = ds + w * sB + bl;
  const T* xp = Xref + w * sB + bl;
  const T* up = Uref + w * sB + bl;
  int ring_in = 0;
  auto copy_tile = [&]() {
    T* const dst = ring + ring_in * L::kRows * kLanes;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        __pipeline_memcpy_async(dst + (L::kK + i * N + c * M + w) * kLanes,
                                kp + (i * N + c * M) * sB, sizeof(T));
    __pipeline_memcpy_async(dst + (L::kD + w) * kLanes, dp, sizeof(T));
#pragma unroll
    for (int c = 0; c < C; ++c)
      __pipeline_memcpy_async(dst + (L::kXo + c * M + w) * kLanes,
                              xp + c * M * sB, sizeof(T));
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

  T xb[N], xd[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    xb[i] = x0[i * sB + bl];
    xd[i] = T(0);
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Xb[(c * M + w) * sB + b] = x0[(c * M + w) * sB + b];
      Xd[(c * M + w) * sB + b] = T(0);
    }
  }

  __pipeline_wait_prior(kStages - 2);  // the tile of step 0 has landed
  __syncthreads();
  // where this thread's entries of step 0 go
  T* ubout = Ub + w * sB + bl;
  T* udout = Ud + w * sB + bl;
  T* xbout = Xb + (N + w) * sB + bl;
  T* xdout = Xd + (N + w) * sB + bl;
  size_t qoff = bl;
  int ring_out = 0;  // the slot this step reads

#pragma unroll 1
  for (int t = 0; t < Hm1; ++t) {
    const T* const tile = ring + ring_out * L::kRows * kLanes;
    ring_out = ring_out == kStages - 1 ? 0 : ring_out + 1;
    T* const ubex = ubsh + (t & 1) * M * kLanes;
    T* const dbex = dbsh + (t & 1) * M * kLanes;
    T* const ddex = ddsh + (t & 1) * M * kLanes;

    T accb = T(0), accd = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T k = tile[(L::kK + w * N + j) * kLanes];
      accb += k * (xb[j] - tile[(L::kXo + j) * kLanes]);
      accd += k * xd[j];
    }
    const T dub = accb;
    const T dud = accd + tile[(L::kD + w) * kLanes];
    const T ub = tile[(L::kUo + w) * kLanes] + dub;
    ubex[w * kLanes] = ub;
    dbex[w * kLanes] = dub;
    ddex[w * kLanes] = dud;

    // refill the slot that step t - 1 has released, then wait for this
    // thread's copies of step t + 1; the barrier publishes them and the
    // exchange (the stores to device memory come after it, so it does not
    // wait on them)
    if (t + kStages - 1 < Hm1) copy_tile();
    __pipeline_commit();
    __pipeline_wait_prior(kStages - 2);
    __syncthreads();

    T u[M], v[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      u[i] = ubex[i * kLanes];
      v[i] = ddex[i * kLanes];
    }
    if constexpr (SECOND) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        xb[i] = xb[i] + dt * xb[M + i] + half_dt2 * u[i];
        xb[M + i] = xb[M + i] + dt * u[i];
        xd[i] = xd[i] + dt * xd[M + i] + half_dt2 * v[i];
        xd[M + i] = xd[M + i] + dt * v[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        xb[i] = xb[i] + dt * u[i];
        xd[i] = xd[i] + dt * v[i];
      }
    }

    if (live) {
      *ubout = ub;
      *udout = dud;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        T xbw = xb[c * M], xdw = xd[c * M];
#pragma unroll
        for (int i = 1; i < M; ++i)
          if (w == i) {
            xbw = xb[c * M + i];
            xdw = xd[c * M + i];
          }
        xbout[c * M * sB] = xbw;
        xdout[c * M * sB] = xdw;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (w != q % M) continue;
        T sum = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T e = q == 2 ? ddex[i * kLanes] : dbex[i * kLanes];
          const T f = q == 0 ? dbex[i * kLanes] : ddex[i * kLanes];
          sum += e * f;
        }
        (q == 0 ? qa : q == 1 ? qb : qc)[qoff] = sum;
      }
    }
    ubout += M * sB;
    udout += M * sB;
    xbout += N * sB;
    xdout += N * sB;
    qoff += sB;
  }
}

template <int M, bool SECOND, typename T>
constexpr int smem_bytes() {
  return static_cast<int>(Tile<M, SECOND>::kVals * kLanes * sizeof(T));
}

template <int M, bool SECOND, typename T>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(affine_family_kernel<M, SECOND, T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<M, SECOND, T>());
}

template <int M, bool SECOND, typename T>
int launch(const T* Ks, const T* ds, const T* Xref, const T* Uref,
           const T* x0, T dt, T half_dt2, T* Xb, T* Xd, T* Ub, T* Ud, T* qa,
           T* qb, T* qc, int Hm1, int B, void* stream) {
  cudaError_t err = set_smem<M, SECOND, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  affine_family_kernel<M, SECOND, T>
      <<<blocks, M * kLanes, smem_bytes<M, SECOND, T>(),
         static_cast<cudaStream_t>(stream)>>>(Ks, ds, Xref, Uref, x0, dt,
                                              half_dt2, Xb, Xd, Ub, Ud, qa, qb,
                                              qc, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, threads a block, dynamic shared memory, blocks the card holds on
// one SM) of a launch at batch B
template <int M, bool SECOND, typename T>
int geometry(int B, int* out) {
  cudaError_t err = set_smem<M, SECOND, T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (B + kLanes - 1) / kLanes;
  out[1] = M * kLanes;
  out[2] = smem_bytes<M, SECOND, T>();
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], affine_family_kernel<M, SECOND, T>, M * kLanes,
      smem_bytes<M, SECOND, T>()));
}

constexpr int kM = AF_M;
constexpr int kN = AF_N;
constexpr bool kSecond = kN != kM;

}  // namespace

// Plain C entry points for ctypes, affine_family_n<n>_m<m>_<type> for this
// library's width and kind. Arrays are contiguous with the lane axis minor:
// Ks [Hm1,m,n,B], ds/Uref [Hm1,m,B], Xref [Hm1+1,n,B] (rows 0..Hm1-1 read),
// x0 [n,B]; out Xb, Xd [Hm1+1,n,B] (row 0: x0 and 0), Ub, Ud [Hm1,m,B],
// qa, qb, qc [Hm1,B]. Each returns the CUDA error code of the launch.
#define AF_ENTRY(N, M, T, TAG)                                                \
  extern "C" int affine_family_n##N##_m##M##_##TAG(                           \
      const T* Ks, const T* ds, const T* Xref, const T* Uref, const T* x0,    \
      T dt, T half_dt2, T* Xb, T* Xd, T* Ub, T* Ud, T* qa, T* qb, T* qc,      \
      int Hm1, int B, void* stream) {                                         \
    return launch<kM, kSecond, T>(Ks, ds, Xref, Uref, x0, dt, half_dt2, Xb,   \
                                  Xd, Ub, Ud, qa, qb, qc, Hm1, B, stream);    \
  }
// one more level, so that the widths expand before ## pastes
#define AF_ENTRY_OF(N, M, T, TAG) AF_ENTRY(N, M, T, TAG)

AF_ENTRY_OF(AF_N, AF_M, float, f32)
AF_ENTRY_OF(AF_N, AF_M, double, f64)

// The launch geometry of this library's width at batch B for an element of
// `itemsize` bytes (4 or 8) -> out[4] = (blocks, threads a block, dynamic
// shared memory in bytes, resident blocks an SM by the CUDA occupancy
// calculator). Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a
// width that is not this library's.
extern "C" int affine_family_geometry(int n, int m, int itemsize, int B,
                                      int* out) {
  if (n != kN || m != kM) return 1;
  return itemsize == 4 ? geometry<kM, kSecond, float>(B, out)
                       : geometry<kM, kSecond, double>(B, out);
}
