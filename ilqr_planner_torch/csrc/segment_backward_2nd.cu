// Whole-sweep backward (Riccati) pass of the lane-major fleet solver for the
// double integrator ('second') and for the sqrt-dt time-optimal first-order
// kind ('time1'), for Hopper (sm_90a).
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
// 2n + m values in and m(n+1) out a lane); in practice latency. Each lane's
// recursion is a serial chain of several thousand operations a step, and
// the solves' batches (B = 2048 .. 4096) are a few dozen lanes an SM, so a
// thread a lane is one warp an SM with every operand a dependent load from
// shared memory (the first design of 'second': 49 us a step at n = 14,
// B = 4096 on an NVIDIA H100 80GB HBM3 at 700 W, 71 times its bytes bound).
//
// The two kinds run two designs.
//
// 'second' (second_kernel): sixteen threads a lane, split over output
// columns and rows, never over a summation index.
//  * A block owns 32 neighbouring lanes and is 16 warps; thread (w, lane)
//    of warp w works on that lane. The threads of one WARP are therefore 32
//    neighbouring lanes on one matrix entry: every global load and store of
//    a warp is one contiguous row piece (a 128-byte line in float32), with
//    the lane axis minor as the solver lays its arrays out, and shared
//    memory laid out [entry][lane] is free of bank conflicts. (Putting the
//    16 threads of a lane side by side in a warp would cut each store into
//    sixteen 8-byte pieces; K and d are 75% of the bytes.) The price is
//    that the threads of a lane meet at block barriers, nine a step.
//  * Warp c < n owns column c of the right-hand side [Qux | Qu], warp n the
//    column Qu, warp j < m also column j of Quu + reg I, all in registers
//    through the elimination. At pivot k the owner of column k publishes it
//    and 1 / pivot (m + 1 values) in shared memory and one barrier later
//    every warp updates its columns; each entry sees the operations of the
//    one-thread elimination in its order.
//  * The carry (P in full, both halves written with one value, and p)
//    lives in shared memory, two copies in turn, because every column owner
//    reads across it; stored in full, a column or a row is a fixed offset
//    from one pointer formed once a step (a packed triangle cost an index
//    computation a load: 1.70 ms against 1.35 at the path's shape). K and d
//    go to device memory straight from their owners' registers and to a
//    shared tile for the value update, where warp i < n forms row i of the
//    new carry from its own Qux column (kept from before the elimination)
//    and K column in registers, each sum over r = 0..m-1 in one thread.
//  * The streamed rows of the next steps are in flight: U, lx and L2 of
//    step t - kAhead are copied by cp.async into a ring of kAhead + 1 row
//    sets at the top of step t (each thread keeps the source pointers of
//    its rows and moves them back a step), a keypoint step's dense Hessian
//    at the top of its own step, before the elimination, and the keypoint
//    slot of step t - 1 is read during step t; nothing on the dependent
//    chain waits on device memory. K and d are stored just after a barrier,
//    not just before one, so that no barrier waits on the stores.
//  * Shared memory: 791 values a lane (two carries 420, K | d 105, pivot
//    columns 56, row ring 105, keypoint Hessian 105): 99 KB a block in
//    float32, 198 KB in float64, so by shared memory an SM holds 64 lanes
//    in float32 and 32 in float64; the 512 threads of a block at 94 to 98
//    registers leave one block (32 lanes) an SM in both types, which is
//    what the solves' B = 4096 puts there (128 blocks on 132 SMs).
//  * What is left (1.23 ms in float32, 4.5 times the bytes bound, about
//    3 us a step): 16 warps taking turns through short phases between
//    barriers. Timing the kernel with the pivot loads or the value update's
//    K loads removed moved float32 by nothing, so shared-memory bandwidth
//    is not the limit; the seven pivots are a chain of publish, barrier,
//    load (a third of the step), and the value update and the columns'
//    assembly are bound by the instructions the four schedulers run,
//    addressing included.
//  * A ragged last block: lanes past B read lane B - 1 and store nothing;
//    no thread leaves before the last barrier.
// Tensor cores (wgmma) are not the tool: the products are 7 x 14 a lane
// inside a serial recursion, and float32 / float64 accuracy is part of the
// result.
//
// 'time1' (time1_kernel): the first design, one thread a lane, 32 threads a
// block, the per-lane working set (224 values) in shared memory
// [entry][thread]; its redesign is later work.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

#ifndef SECOND_AHEAD
#define SECOND_AHEAD 2
#endif
constexpr int kLanes = 32;            // lanes a block, both designs
constexpr int kGroup = 16;            // 'second': warps a block = threads a lane
constexpr int kAhead = SECOND_AHEAD;  // 'second': steps whose rows are in flight

// index of (i, j), i <= j, in a row-major upper triangle of an N x N matrix
template <int N>
__device__ __forceinline__ int tri(int i, int j) {
  return i * N - (i * (i - 1)) / 2 + (j - i);
}

template <int N>
__device__ __forceinline__ int sym(int i, int j) {
  return i <= j ? tri<N>(i, j) : tri<N>(j, i);
}

// entry e of a shared buffer whose base already points at this thread's lane
#define SH(base, e) (base)[(e) * kLanes]

// ---------------------------------------------------------------------------
// 'second': sixteen threads a lane
// ---------------------------------------------------------------------------

template <int M>
struct SecondLayout {
  static constexpr int N = 2 * M;
  static constexpr int NX = N + 1;                 // columns of [Qux | Qu]
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kCarry = N * N + N;         // P (both halves), p
  static constexpr int kGain = M * NX;             // K | d
  static constexpr int kPiv = M * (M + 1);         // pivot columns, 1 / pivot
  static constexpr int kRows = 2 * N + M;          // U, lx, L2 of one step
  static constexpr int kVals =
      2 * kCarry + kGain + kPiv + (kAhead + 1) * kRows + kTri;
};

template <int M, typename T>
__global__ void __launch_bounds__(kGroup * kLanes)
second_kernel(const T* __restrict__ P0, const T* __restrict__ p0,
              const T* __restrict__ L2, const T* __restrict__ lx,
              const T* __restrict__ U, const T* __restrict__ gxx,
              const int* __restrict__ slots, const T* __restrict__ params,
              T* __restrict__ Ks, T* __restrict__ ds, int Hm1, int B) {
  using L = SecondLayout<M>;
  constexpr int N = L::N;
  constexpr int NX = L::NX;
  constexpr int DOF = M;
  static_assert(kGroup >= NX, "one warp a column of [Qux | Qu]");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x / kLanes;  // the column / row this thread owns
  const int l = threadIdx.x % kLanes;
  const int b = blockIdx.x * kLanes + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;     // the lane whose inputs are read
  const size_t sB = static_cast<size_t>(B);

  // The carry holds P in full, entry (i, j) at i * N + j, both halves
  // written with one value, so a column owner reads column c at a fixed
  // offset from a pointer it forms once a step; p follows at N * N.
  T* cur = reinterpret_cast<T*>(smem_raw) + l;  // carry of step t + 1
  T* nxt = cur + L::kCarry * kLanes;            // carry being written
  T* const Ksh = cur + 2 * L::kCarry * kLanes;  // [M][NX]: K | d
  T* const Psh = Ksh + L::kGain * kLanes;       // [M][M + 1]
  T* const Rsh = Psh + L::kPiv * kLanes;        // [kAhead + 1][kRows]
  T* const Gsh = Rsh + (kAhead + 1) * L::kRows * kLanes;  // [kTri]
  // row w of the keypoint Hessian's upper triangle: entry (w, j) at gw + j
  const int gw = tri<N>(w < N ? w : 0, 0);

  const T dt = params[0];
  const T b1 = params[1];  // dt^2 / 2, rounded once from double
  const T reg = params[2];

  // The streamed rows of a step (U, lx, L2: kRows rows) are copied into a
  // ring slot by rows w, w + kGroup, ...: this thread's source pointers,
  // at the last step, each moved back one step after a copy.
  constexpr int kMine = (L::kRows + kGroup - 1) / kGroup;
  const T* src[kMine];
  size_t back[kMine];
#pragma unroll
  for (int q = 0; q < kMine; ++q) {
    const int r = w + q * kGroup;
    const size_t last = static_cast<size_t>(Hm1 - 1);
    if (r < M) {
      src[q] = U + (last * M + r) * sB + bl;
      back[q] = M * sB;
    } else if (r < M + N) {
      src[q] = lx + (last * N + (r - M)) * sB + bl;
      back[q] = N * sB;
    } else {
      src[q] = L2 + (last * N + (r - M - N)) * sB + bl;  // unused past kRows
      back[q] = N * sB;
    }
  }
  int ring_in = 0;  // the ring slot the next copy fills
  auto copy_rows = [&]() {
    T* const dst = Rsh + ring_in * L::kRows * kLanes;
#pragma unroll
    for (int q = 0; q < kMine; ++q) {
      if (w + q * kGroup < L::kRows)
        __pipeline_memcpy_async(&SH(dst, w + q * kGroup), src[q], sizeof(T));
      src[q] -= back[q];
    }
    ring_in = ring_in == kAhead ? 0 : ring_in + 1;
  };

  for (int s = 0; s < kAhead; ++s) {
    if (Hm1 - 1 - s >= 0) copy_rows();
    __pipeline_commit();
  }
  // where the gains of the last step go; each step moves these back
  T* kout = Ks + (static_cast<size_t>(Hm1 - 1) * M * N + (w < N ? w : 0)) * sB + bl;
  T* dout = ds + static_cast<size_t>(Hm1 - 1) * M * sB + bl;
  int slot_next = slots[Hm1 - 1];
  int ring_out = 0;  // the ring slot this step reads
  if (w < N) {
    SH(cur, N * N + w) = p0[w * sB + bl];
    for (int j = w; j < N; ++j) {
      const T v = P0[(w * N + j) * sB + bl];
      SH(cur, w * N + j) = v;
      SH(cur, j * N + w) = v;
    }
  }
  __pipeline_wait_prior(kAhead - 1);  // the rows of step Hm1 - 1 have landed
  __syncthreads();

#pragma unroll 1
  for (int t = Hm1 - 1; t >= 0; --t) {
    // the slot is read a step ahead: its load is off the step's chain
    const int slot = slot_next;
    if (t > 0) slot_next = slots[t - 1];
    if (slot >= 0 && w < N) {  // row w of this step's keypoint Hessian
      const T* const g = gxx + static_cast<size_t>(slot) * N * N * sB + bl;
      for (int j = w; j < N; ++j)
        __pipeline_memcpy_async(&SH(Gsh, gw + j), g + (w * N + j) * sB,
                                sizeof(T));
    }
    if (t - kAhead >= 0) copy_rows();
    __pipeline_commit();
    const T* const rows = Rsh + ring_out * L::kRows * kLanes;
    ring_out = ring_out == kAhead ? 0 : ring_out + 1;
    const T* const pvec = cur + N * N * kLanes;  // p

    // 1. this warp's columns of the system [Quu + reg I | Qux | Qu]. With
    // PA = P A (dt * q-columns added to the dq-columns), column c of
    // Qux = B^T PA is b1 PA[r][c] + dt PA[r + dof][c].
    T x[M], qc[M], a[M];
#pragma unroll
    for (int r = 0; r < M; ++r) x[r] = qc[r] = a[r] = T(0);
    if (w < DOF) {
      const T* const pc = cur + w * kLanes;  // P[:, w], entry a at a * N
#pragma unroll
      for (int r = 0; r < M; ++r)
        x[r] = qc[r] = b1 * SH(pc, r * N) + dt * SH(pc, (r + DOF) * N);
      const T* const pd = pc + DOF * kLanes;  // P[:, w + dof]
      const T Rtw = params[3 + w];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T pb_i = b1 * SH(pc, i * N) + dt * SH(pd, i * N);
        const T pb_di = b1 * SH(pc, (i + DOF) * N) + dt * SH(pd, (i + DOF) * N);
        T q = b1 * pb_i + dt * pb_di;
        if (i == w) q = q + Rtw + reg;
        a[i] = q;
      }
    } else if (w < N) {
      const T* const pc = cur + w * kLanes;   // P[:, w]
      const T* const pq = pc - DOF * kLanes;  // P[:, w - dof]
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const T pa_r = SH(pc, r * N) + dt * SH(pq, r * N);
        const T pa_d = SH(pc, (r + DOF) * N) + dt * SH(pq, (r + DOF) * N);
        x[r] = qc[r] = b1 * pa_r + dt * pa_d;
      }
    } else if (w == N) {
#pragma unroll
      for (int r = 0; r < M; ++r)
        x[r] = params[3 + r] * SH(rows, r) +
               (b1 * SH(pvec, r) + dt * SH(pvec, r + DOF));
    }

    // 2. Gauss-Jordan without pivoting: [I | S | s], a barrier a pivot
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (w == k) {
#pragma unroll
        for (int i = 0; i < M; ++i) SH(Psh, k * (M + 1) + i) = a[i];
        SH(Psh, k * (M + 1) + M) = T(1) / a[k];
      }
      __syncthreads();
      T fac[M];
#pragma unroll
      for (int r = 0; r < M; ++r) fac[r] = SH(Psh, k * (M + 1) + r);
      const T piv = SH(Psh, k * (M + 1) + M);
      if (w <= N) {
        x[k] = x[k] * piv;
#pragma unroll
        for (int r = 0; r < M; ++r)
          if (r != k) x[r] = x[r] - fac[r] * x[k];
      }
      if (w < M && w > k) {
        a[k] = a[k] * piv;
#pragma unroll
        for (int r = 0; r < M; ++r)
          if (r != k) a[r] = a[r] - fac[r] * a[k];
      }
    }

    // 3. gains K = -S, d = -s: to the shared tile, then, past the barrier
    // (so that it does not wait on the stores), to device memory
    if (w <= N) {
#pragma unroll
      for (int r = 0; r < M; ++r) {
        x[r] = -x[r];
        SH(Ksh, r * NX + w) = x[r];
      }
    }
    if (slot >= 0) __pipeline_wait_prior(0);  // the keypoint Hessian
    __syncthreads();
    if (live) {
      if (w < N) {
#pragma unroll
        for (int r = 0; r < M; ++r) kout[r * N * sB] = x[r];
      } else if (w == N) {
#pragma unroll
        for (int r = 0; r < M; ++r) dout[r * sB] = x[r];
      }
    }
    kout -= M * N * sB;
    dout -= M * sB;

    // 4. value update: warp i writes row i (and, mirrored, column i) of the
    // other carry buffer, from its Qux column qc and its K column x
    if (w < N) {
      const int i = w;
      const bool low = i >= DOF;                // a dq-row: A^T adds dt * q-row
      const T* const pr = cur + i * N * kLanes;  // P[i, :]
      const T* const pq = low ? pr - DOF * N * kLanes : pr;  // P[i - dof, :]
      T s1 = T(0), s2 = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const T dr = SH(Ksh, r * NX + N);
        s1 += qc[r] * dr;
        s2 += x[r] * dr;
      }
      T qx = SH(rows, M + i);
      qx = qx + (low ? SH(pvec, i) + dt * SH(pvec, i - DOF) : SH(pvec, i));
      SH(nxt, N * N + i) = (qx + s1) - reg * s2;

      const T l2i = SH(rows, M + N + i);
      T* const nr = nxt + i * N * kLanes;  // new P[i, :]
      T* const nc = nxt + i * kLanes;      // new P[:, i]
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < i) continue;
        T a1 = T(0), a2 = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const T kj = SH(Ksh, r * NX + j);
          a1 += qc[r] * kj;
          a2 += x[r] * kj;
        }
        T stage = i == j ? l2i : T(0);
        if (slot >= 0) stage = stage + SH(Gsh, gw + j);
        // PA[i][j], and for a dq-row dt * PA[i - dof][j] more
        T pa = j < DOF ? SH(pr, j) : SH(pr, j) + dt * SH(pr, j - DOF);
        if (low)
          pa = pa + dt * (j < DOF ? SH(pq, j)
                                  : SH(pq, j) + dt * SH(pq, j - DOF));
        const T v = ((stage + pa) + a1) - reg * a2;
        SH(nr, j) = v;
        SH(nc, j * N) = v;
      }
    }
    __pipeline_wait_prior(kAhead - 1);  // the rows of step t - 1 have landed
    __syncthreads();
    T* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <int M, typename T>
constexpr int second_smem() {
  return static_cast<int>(SecondLayout<M>::kVals * kLanes * sizeof(T));
}

template <int M, typename T>
int launch_second(const T* P0, const T* p0, const T* L2, const T* lx,
                  const T* U, const T* gxx, const int* slots, const T* params,
                  T* Ks, T* ds, int Hm1, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      second_kernel<M, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      second_smem<M, T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  second_kernel<M, T><<<blocks, kGroup * kLanes, second_smem<M, T>(),
                        static_cast<cudaStream_t>(stream)>>>(
      P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 'time1': one thread a lane
// ---------------------------------------------------------------------------

template <int N>
struct Time1Layout {
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kCarry = kTri + N;           // P upper triangle, p
  static constexpr int kVals = 2 * kCarry + N * N + N * (N + 1);
};

template <int N, typename T>
__global__ void __launch_bounds__(kLanes)
time1_kernel(const T* __restrict__ P0, const T* __restrict__ p0,
             const T* __restrict__ L2, const T* __restrict__ lx,
             const T* __restrict__ U, const T* __restrict__ gxx,
             const int* __restrict__ slots, const T* __restrict__ params,
             T* __restrict__ Ks, T* __restrict__ ds, int Hm1, int B) {
  constexpr int M = N;
  constexpr int DOF = M - 1;
  constexpr int TRI = Time1Layout<N>::kTri;
  constexpr int CARRY = Time1Layout<N>::kCarry;
  constexpr int NX = N + 1;  // columns of the right-hand side [Qux | Qu]

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x * kLanes + threadIdx.x;
  if (b >= B) return;  // no barrier in this kernel
  const size_t sB = static_cast<size_t>(B);

  T* const lane = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  T* cur = lane;                        // carry of step t + 1
  T* nxt = lane + CARRY * kLanes;       // carry being written
  T* const Ash = lane + 2 * CARRY * kLanes;
  T* const Xsh = Ash + M * M * kLanes;
#define A_(i, j) SH(Ash, (i) * M + (j))
#define X_(i, j) SH(Xsh, (i) * NX + (j))

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

    // B is read from the control: s = u[m-1]
    const T s = u[M - 1];
    const T dtk = s * s;
    const T h = T(2) * s;
    T g[DOF];
#pragma unroll
    for (int i = 0; i < DOF; ++i) g[i] = h * u[i];

    // the rows of Qux = B^T P, column c
    auto qux = [&](int r, int c) -> T {
      if (r < DOF) return dtk * P(r, c);
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < DOF; ++q) acc += g[q] * P(q, c);
      return acc + h * P(N - 1, c);
    };

    // 1. the system [Quu + reg I | Qux | Qu]
    {
      // PB's last column: P g-column plus h P[:, n-1]
      T pbl[N];
#pragma unroll
      for (int a = 0; a < N; ++a) {
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < DOF; ++q) acc += P(a, q) * g[q];
        pbl[a] = acc + P(a, N - 1) * h;
      }
#pragma unroll
      for (int j = 0; j < M; ++j) {
        // Quu[i][j] = dtk PB[i][j] (i < dof), and the chain-rule row
        T acc = T(0);
#pragma unroll
        for (int q = 0; q < DOF; ++q)
          acc += g[q] * (j < DOF ? dtk * P(q, j) : pbl[q]);
        T last = acc + h * (j < DOF ? dtk * P(N - 1, j) : pbl[N - 1]);
#pragma unroll
        for (int i = 0; i < DOF; ++i) {
          T q = dtk * (j < DOF ? dtk * P(i, j) : pbl[i]);
          if (i == j) q = q + Rt[i] + reg;
          A_(i, j) = q;
        }
        if (j == DOF) last = last + Rt[DOF] + reg;
        A_(DOF, j) = last;
      }
      T acc = T(0);
#pragma unroll
      for (int q = 0; q < DOF; ++q) acc += g[q] * pv(q);
#pragma unroll
      for (int i = 0; i < DOF; ++i) X_(i, N) = Rt[i] * u[i] + dtk * pv(i);
      X_(DOF, N) = Rt[DOF] * u[DOF] + (acc + h * pv(N - 1));
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
      const T qx = lx[rowN + i * sB] + pv(i);
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
        const T qxx = P(i, j) + stage;
        SH(nxt, tri<N>(i, j)) = (qxx + a1) - reg * a2;
      }
    }
    T* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
#undef A_
#undef X_
}

template <int N, typename T>
constexpr int time1_smem() {
  return static_cast<int>(Time1Layout<N>::kVals * kLanes * sizeof(T));
}

template <int N, typename T>
int launch_time1(const T* P0, const T* p0, const T* L2, const T* lx,
                 const T* U, const T* gxx, const int* slots, const T* params,
                 T* Ks, T* ds, int Hm1, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      time1_kernel<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      time1_smem<N, T>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  time1_kernel<N, T><<<blocks, kLanes, time1_smem<N, T>(),
                       static_cast<cudaStream_t>(stream)>>>(
      P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, threads a block, dynamic shared memory, blocks the card holds on
// one SM) of a launch of `kernel` at batch B
template <typename Kernel>
int geometry(Kernel kernel, int threads, int smem, int B, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (B + kLanes - 1) / kLanes;
  out[1] = threads;
  out[2] = smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], kernel, threads, smem));
}

#undef SH

}  // namespace

// Plain C entry points for ctypes. Arrays are contiguous with the lane axis
// minor: P0 [n,n,B], p0 [n,B], L2/lx [Hm1,n,B], U [Hm1,m,B],
// gxx [n_kp,n,n,B] (upper triangle read), slots [Hm1] (-1 off keypoints),
// params [3+m] = (dt, dt^2/2, reg, Rt); out Ks [Hm1,m,n,B], ds [Hm1,m,B].
// 'second' at n = 14, m = 7; 'time1' at n = m = 8 (dt unused). Each returns
// the CUDA error code of the launch.
#define SWEEP_ENTRY(NAME, LAUNCH, W, T)                                       \
  extern "C" int NAME(const T* P0, const T* p0, const T* L2, const T* lx,     \
                      const T* U, const T* gxx, const int* slots,             \
                      const T* params, T* Ks, T* ds, int Hm1, int B,          \
                      void* stream) {                                         \
    return LAUNCH<W, T>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1,   \
                        B, stream);                                           \
  }

SWEEP_ENTRY(segment_backward_second_f32, launch_second, 7, float)
SWEEP_ENTRY(segment_backward_second_f64, launch_second, 7, double)
SWEEP_ENTRY(segment_backward_time1_f32, launch_time1, 8, float)
SWEEP_ENTRY(segment_backward_time1_f64, launch_time1, 8, double)

// The launch geometry of a kind (0 'second', 1 'time1') at batch B for an
// element of `itemsize` bytes (4 or 8) -> out[4] = (blocks, threads a
// block, dynamic shared memory in bytes, resident blocks an SM by the CUDA
// occupancy calculator). Returns a CUDA error code.
extern "C" int segment_backward_2nd_geometry(int kind, int itemsize, int B,
                                             int* out) {
  if (kind == 0)
    return itemsize == 4
               ? geometry(second_kernel<7, float>, kGroup * kLanes,
                          second_smem<7, float>(), B, out)
               : geometry(second_kernel<7, double>, kGroup * kLanes,
                          second_smem<7, double>(), B, out);
  return itemsize == 4 ? geometry(time1_kernel<8, float>, kLanes,
                                  time1_smem<8, float>(), B, out)
                       : geometry(time1_kernel<8, double>, kLanes,
                                  time1_smem<8, double>(), B, out);
}
