// The fleet solver's joint-limit penalty over whole trajectories, in one
// streaming pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package computes the penalty in plain jnp
// (ilqr_planner_tpu/solvers/fleet.py: _limit_cost_full, _limit_arrays),
// which XLA fuses into one pass on the TPU. Eager PyTorch runs the same math
// (ops/cuda_kernels/limit_penalty.py: limit_cost_reference,
// limit_arrays_reference) as some 13 launches a limited subsystem over
// full-width temporaries, and the affine line search first materialised the
// trial trajectory Xa = Xb + alpha Xd for them. Per element x of a
// trajectory [H, n, B] and per limited subsystem s (its smax, smin, weight
// and penalty p: rows of a table [nsub, 4, n]):
//   over = x > smax_j,  under = x < smin_j,
//   active = w_j != 0 && (over || under),
//   Ld = active ? p : 0,  ql = active ? (over ? smax_j - x : under ? smin_j - x : 0) : 0,
// in two forms:
//   cost [B]:         the sum over steps, coordinates and subsystems of
//                     Ld ql ql, at x = xb or at x = xb + alpha xd (a trial of
//                     the affine family, read from its base and direction);
//   arrays [H, n, B]: lx = -(0 + sum_s Ld ql), L2 = 0 + sum_s Ld Ld.
//
// What bounds it on the H100: bytes. About ten operations an element
// against 4 or 8 bytes read (cost, float32) or 4 read and 8 written
// (arrays).
//
// What this design does about it:
//  * Lane-major rows, B contiguous: a thread takes V neighbouring lanes,
//    V = 16 / sizeof(T) (one 16-byte load a row) where B, the pointers and
//    the step stride allow it, else 1; a warp's piece of a row is one
//    contiguous run. The step stride is an argument, so the affine family's
//    base and direction are read where they lie, interleaved in one array.
//  * Cost: each thread walks the rows (step, coordinate) of its lanes and
//    sums the penalty in registers, so each element is read once and no
//    temporary is written. x = xb + alpha xd is a separate multiply and add
//    (the _rn intrinsics: no contraction into an FMA), so x, and with it the
//    active sets, NaN lanes (never active) and inf lanes (penalty inf), are
//    the plain path's bit for bit; only the order of a lane's sum differs.
//    Where B gives too few threads to fill the card (131072 lanes in
//    float32, replan-sized batches, one problem), a block's TY rows of
//    threads split the rows and add their sums in shared memory in the
//    fixed order ty = 0, 1, ...: no atomics, so a result does not vary from
//    run to run.
//    A block is at least 128 threads, so that 16 blocks fill an SM.
//  * Arrays: elementwise, a block a run of rows; the subsystems' terms are
//    added in the plain path's order, so lx and L2 are its bits.
//  * The table is a few values, read warp-uniformly through the read-only
//    cache.

#include <cuda_runtime.h>

namespace {

// Threads of an arrays block.
#define LP_ARRAYS_THREADS 128
constexpr int kArraysThreads = LP_ARRAYS_THREADS;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// V neighbouring lanes of one row, one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// The penalty weight Ld and the clipped gap ql of element x under one
// subsystem's row of the table (the plain path's where-chain).
template <typename T>
__device__ __forceinline__ void terms(T x, T smax, T smin, T w, T p, T& Ld,
                                      T& ql) {
  const bool over = x > smax;
  const bool under = x < smin;
  const bool active = (w != T(0)) && (over || under);
  const T q = over ? sub_rn(smax, x) : (under ? sub_rn(smin, x) : T(0));
  Ld = active ? p : T(0);
  ql = active ? q : T(0);
}

// cost [B] of x = xb (AFFINE false) or x = xb + alpha xd. Block (LX, TY):
// thread (tx, ty) takes lane vector blockIdx.x * LX + tx and rows ty,
// ty + TY, ...; red holds the partial sums of threads ty = 1..TY-1.
template <typename T, int V, bool AFFINE>
__global__ void __launch_bounds__(1024)
limit_penalty_cost_kernel(const T* __restrict__ xb, const T* __restrict__ xd,
                          T alpha, long long sk, const T* __restrict__ table,
                          int nsub, int H, int n, int B, T* __restrict__ cost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const red = reinterpret_cast<T*>(smem_raw);  // [TY][LX][V]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int LX = blockDim.x;
  const int TY = blockDim.y;
  const int vi = blockIdx.x * LX + tx;
  const bool live = vi < B / V;
  const long long b0 = static_cast<long long>(live ? vi : 0) * V;
  const long long sB = B;

  T acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = T(0);
  if (live) {
    const int rows = H * n;
    const int dk = TY / n, dj = TY % n;
    int k = ty / n, j = ty % n;
#pragma unroll 4
    for (int r = ty; r < rows; r += TY) {
      const long long off = k * sk + j * sB + b0;
      Pack<T, V> x = *reinterpret_cast<const Pack<T, V>*>(xb + off);
      if (AFFINE) {
        const Pack<T, V> d = *reinterpret_cast<const Pack<T, V>*>(xd + off);
#pragma unroll
        for (int i = 0; i < V; ++i) x.v[i] = add_rn(x.v[i], mul_rn(alpha, d.v[i]));
      }
      for (int s = 0; s < nsub; ++s) {
        const T* const row = table + 4 * n * s + j;
        const T smax = __ldg(row), smin = __ldg(row + n);
        const T w = __ldg(row + 2 * n), p = __ldg(row + 3 * n);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          T Ld, ql;
          terms(x.v[i], smax, smin, w, p, Ld, ql);
          acc[i] = add_rn(acc[i], mul_rn(mul_rn(Ld, ql), ql));
        }
      }
      j += dj;
      k += dk;
      if (j >= n) {
        j -= n;
        ++k;
      }
    }
  }
  if (TY > 1) {
    if (ty > 0) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[(ty * LX + tx) * V + i] = acc[i];
    }
    __syncthreads();
    if (ty == 0) {
      for (int t = 1; t < TY; ++t) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] = add_rn(acc[i], red[(t * LX + tx) * V + i]);
      }
    }
  }
  if (ty == 0 && live) {
    Pack<T, V> out;
#pragma unroll
    for (int i = 0; i < V; ++i) out.v[i] = acc[i];
    *reinterpret_cast<Pack<T, V>*>(cost + b0) = out;
  }
}

// lx, L2 [H, n, B] (contiguous) of x [H, n, B] (step stride sk). Block
// (kArraysThreads): lane vectors blockIdx.x * kArraysThreads + threadIdx.x,
// rows blockIdx.y * rows_per_block onwards.
template <typename T, int V>
__global__ void __launch_bounds__(kArraysThreads)
limit_penalty_arrays_kernel(const T* __restrict__ x, long long sk,
                            const T* __restrict__ table, int nsub, int H, int n,
                            int B, int rows_per_block, T* __restrict__ lx,
                            T* __restrict__ L2) {
  const int vi = blockIdx.x * kArraysThreads + threadIdx.x;
  if (vi >= B / V) return;
  const long long b0 = static_cast<long long>(vi) * V;
  const long long sB = B;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, H * n);
  int k = r0 / n, j = r0 % n;
  for (int r = r0; r < r1; ++r) {
    const Pack<T, V> xv =
        *reinterpret_cast<const Pack<T, V>*>(x + k * sk + j * sB + b0);
    Pack<T, V> lq, l2;
#pragma unroll
    for (int i = 0; i < V; ++i) lq.v[i] = l2.v[i] = T(0);
    for (int s = 0; s < nsub; ++s) {
      const T* const row = table + 4 * n * s + j;
      const T smax = __ldg(row), smin = __ldg(row + n);
      const T w = __ldg(row + 2 * n), p = __ldg(row + 3 * n);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        T Ld, ql;
        terms(xv.v[i], smax, smin, w, p, Ld, ql);
        lq.v[i] = add_rn(lq.v[i], mul_rn(Ld, ql));
        l2.v[i] = add_rn(l2.v[i], mul_rn(Ld, Ld));
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) lq.v[i] = -lq.v[i];
    const long long off = r * sB + b0;
    *reinterpret_cast<Pack<T, V>*>(lx + off) = lq;
    *reinterpret_cast<Pack<T, V>*>(L2 + off) = l2;
    if (++j == n) {
      j = 0;
      ++k;
    }
  }
}

template <typename T, int V>
int launch_cost(const T* xb, const T* xd, T alpha, long long sk,
                const T* table, int nsub, int H, int n, int B, int LX, int TY,
                T* cost, cudaStream_t stream) {
  const int nv = B / V;
  const dim3 grid((nv + LX - 1) / LX);
  const dim3 block(LX, TY);
  const size_t smem = sizeof(T) * V * LX * TY;
  if (xd != nullptr)
    limit_penalty_cost_kernel<T, V, true><<<grid, block, smem, stream>>>(
        xb, xd, alpha, sk, table, nsub, H, n, B, cost);
  else
    limit_penalty_cost_kernel<T, V, false><<<grid, block, smem, stream>>>(
        xb, xd, alpha, sk, table, nsub, H, n, B, cost);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_arrays(const T* x, long long sk, const T* table, int nsub, int H,
                  int n, int B, int rows_per_block, T* lx, T* L2,
                  cudaStream_t stream) {
  const int nv = B / V;
  const dim3 grid((nv + kArraysThreads - 1) / kArraysThreads,
                  (H * n + rows_per_block - 1) / rows_per_block);
  limit_penalty_arrays_kernel<T, V><<<grid, kArraysThreads, 0, stream>>>(
      x, sk, table, nsub, H, n, B, rows_per_block, lx, L2);
  return static_cast<int>(cudaGetLastError());
}

// The arguments a launch cannot take: a vector width other than 1 and
// 16 / sizeof(T), or one that does not divide B.
template <typename T>
bool bad_shape(int H, int n, int B, int V, int nsub) {
  constexpr int kVec = 16 / sizeof(T);
  return H < 1 || n < 1 || B < 1 || nsub < 1 || (V != 1 && V != kVec) ||
         B % V != 0;
}

template <typename T>
int cost_entry(const T* xb, const T* xd, T alpha, long long sk,
               const T* table, int nsub, int H, int n, int B, int V, int LX,
               int TY, T* cost, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (bad_shape<T>(H, n, B, V, nsub) || LX < 32 || LX % 32 != 0 || TY < 1 ||
      LX * TY > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return V == 1 ? launch_cost<T, 1>(xb, xd, alpha, sk, table, nsub, H, n, B,
                                    LX, TY, cost, s)
                : launch_cost<T, kVec>(xb, xd, alpha, sk, table, nsub, H, n,
                                       B, LX, TY, cost, s);
}

template <typename T>
int arrays_entry(const T* x, long long sk, const T* table, int nsub, int H,
                 int n, int B, int V, int rows_per_block, T* lx, T* L2,
                 void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (bad_shape<T>(H, n, B, V, nsub) || rows_per_block < 1 ||
      (H * n + rows_per_block - 1) / rows_per_block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  return V == 1 ? launch_arrays<T, 1>(x, sk, table, nsub, H, n, B,
                                      rows_per_block, lx, L2, s)
                : launch_arrays<T, kVec>(x, sk, table, nsub, H, n, B,
                                         rows_per_block, lx, L2, s);
}

}  // namespace

// Plain C entry points for ctypes. x / xb / xd [H, n, B] with the lane axis
// contiguous, rows of one step B apart and steps sk elements apart (xb and
// xd alike; xd null for the plain cost); table [nsub, 4, n] (smax, smin,
// weight, penalty) contiguous; outputs contiguous: cost [B], lx / L2
// [H, n, B]. V: lanes a thread (1 or 16 / sizeof(T), dividing B, with the
// pointers and sk aligned to it); (LX, TY): a cost block, LX threads along
// the lanes (a multiple of 32), TY along the rows; rows_per_block: rows an
// arrays block. The launch geometry is the wrapper's
// (`limit_penalty.launch_geometry`). Each returns the CUDA error code of the
// launch.
#define LP_ENTRIES(T, TAG)                                                    \
  extern "C" int limit_penalty_cost_##TAG(                                    \
      const T* xb, const T* xd, T alpha, long long sk, const T* table,        \
      int nsub, int H, int n, int B, int V, int LX, int TY, T* cost,          \
      void* stream) {                                                         \
    return cost_entry<T>(xb, xd, alpha, sk, table, nsub, H, n, B, V, LX, TY,  \
                         cost, stream);                                       \
  }                                                                           \
  extern "C" int limit_penalty_arrays_##TAG(                                  \
      const T* x, long long sk, const T* table, int nsub, int H, int n,       \
      int B, int V, int rows_per_block, T* lx, T* L2, void* stream) {         \
    return arrays_entry<T>(x, sk, table, nsub, H, n, B, V, rows_per_block,    \
                           lx, L2, stream);                                   \
  }

LP_ENTRIES(float, f32)
LP_ENTRIES(double, f64)
