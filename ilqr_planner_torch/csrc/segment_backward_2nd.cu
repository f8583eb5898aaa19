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
// shared memory (the first designs, one thread a lane: 'second' 49 us a
// step at n = 14, B = 4096, 71 times its bytes bound; 'time1' 35 us a step
// at n = 8, B = 2048, 147 times, on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Both kinds run one design, one body (`sweep`) with the kind's assembly
// and value-update terms as a policy (`Second`, `Time1`): several threads
// a lane, split over output columns and rows, never over a summation
// index, so that every sum runs in one thread in the one-thread order.
//  * A block owns kLanes neighbouring lanes; thread (w, lane) with
//    w = threadIdx.x / kLanes works on that lane. At 32 lanes the threads of
//    one WARP are 32 neighbouring lanes on one matrix entry: every global
//    load and store of a warp is one contiguous row piece (a 128-byte line
//    in float32), with the lane axis minor as the solver lays its arrays
//    out, and shared memory laid out [entry][lane] is free of bank
//    conflicts (at 16 lanes a warp is 16 lanes on two entries: 64-byte
//    pieces). (Putting the threads of a lane side by side in a warp would
//    cut each store into 8-byte pieces; K and d are 75% of the bytes.) The
//    price is that the threads of a lane meet at block barriers: m + 2 a
//    step.
//  * Thread w < n owns column w of the right-hand side [Qux | Qu], thread n
//    the column Qu, thread w < m also column w of Quu + reg I, all in
//    registers through the elimination ('second': n + 2 threads a lane, n + 1
//    own a column; 'time1': n + 1; at 7 DoF 16 and 9). At pivot k the owner of column k publishes it
//    and 1 / pivot (m + 1 values) in shared memory and one barrier later
//    every owner updates its columns; each entry sees the operations of the
//    one-thread elimination in its order. 'time1' reads B from the lane's
//    own control: every owner reads the step's m controls from the ring.
//  * The carry (P in full, both halves written with one value, and p)
//    lives in shared memory, two copies in turn, because every column owner
//    reads across it; stored in full, a column or a row is a fixed offset
//    from one pointer formed once a step (a packed triangle cost an index
//    computation a load: 1.70 ms against 1.35 for 'second' at its path's
//    shape). K and d go to device memory straight from their owners'
//    registers and to a shared tile for the value update, where thread
//    i < n forms row i of the new carry from its own Qux column (formed
//    once, before the elimination, and kept) and K column in registers,
//    each sum over r = 0..m-1 in one thread.
//  * The streamed rows of the next steps are in flight: U, lx and L2 of
//    step t - kAhead are copied by cp.async into a ring of kAhead + 1 row
//    sets at the top of step t (each thread keeps the source pointers of
//    its rows and moves them back a step), a keypoint step's dense Hessian
//    at the top of its own step, before the elimination, and the keypoint
//    slot of step t - 1 is read during step t; nothing on the dependent
//    chain waits on device memory. K and d are stored just after a barrier,
//    not just before one, so that no barrier waits on the stores.
//  * Shared memory a lane: two carries 2(n^2 + n), K | d m(n + 1), pivot
//    columns m(m + 1), row ring (kAhead + 1)(2n + m), keypoint Hessian
//    n(n + 1)/2. 'second' (n = 14, 32 lanes, 16 threads a lane): 791 values,
//    99 KB a block in float32, 198 KB in float64; the 512 threads of a block
//    at 94 to 98 registers leave one block (32 lanes) an SM in both types,
//    which is what the solves' B = 4096 puts there (128 blocks on 132 SMs).
//    'time1' (n = m = 8, 9 threads a lane, 16 lanes a block, 160 threads
//    launched): 396 values, 25,344 bytes a block in float32 and 50,688 in
//    float64; at 64 / 96 registers the occupancy calculator puts 6 blocks
//    (96 lanes) an SM in float32 and 4 (64) in float64, and timeopt's
//    B = 2048 puts 128 blocks, one an SM.
//  * Measured on an NVIDIA H100 80GB HBM3 at 700 W
//    (tools/kernel_variants.py, float32 / float64): 'time1' at timeopt's
//    shape 0.216 / 0.260 ms at 16 lanes a block, 0.237 / 0.330 at 32 (the
//    first design, one thread a lane: 3.22 / 3.61); rows 1 or 2 steps
//    ahead alike. 2.2 us a step, 9 times the bytes bound.
//  * What is left in 'second' (1.23 ms in float32, 4.5 times the bytes
//    bound, about 3 us a step): the threads taking turns through short
//    phases between barriers. Timing the kernel with the pivot loads or the
//    value update's K loads removed moved float32 by nothing, so
//    shared-memory bandwidth is not the limit; the seven pivots are a chain
//    of publish, barrier, load (a third of the step), and the value update
//    and the columns' assembly are bound by the instructions the four
//    schedulers run, addressing included.
//  * A ragged last block: lanes past B read lane B - 1 and store nothing;
//    no thread leaves before the last barrier.
// Tensor cores (wgmma) are not the tool: the products are 7 x 14 and 8 x 9
// a lane inside a serial recursion, and float32 / float64 accuracy is part
// of the result.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// The kind and width of this library, built at first use: SECOND_M = m
// (the chain's DoF; n = 2m) for 'second', or TIME1_N = n = m (the DoF plus
// the time state) for 'time1'.
#if defined(SECOND_M) == defined(TIME1_N)
#error "build with one of -DSECOND_M=<m> and -DTIME1_N=<n>"
#endif
#ifndef SECOND_AHEAD
#define SECOND_AHEAD 2
#endif
#ifndef TIME1_LANES
#define TIME1_LANES 16
#endif
#ifndef TIME1_AHEAD
#define TIME1_AHEAD 2
#endif

// 'second': 32 lanes a block, n + 2 threads a lane (warps a block): one a
// column of [Qux | Qu] and a spare that takes its share of the copies
// (sixteen at 7 DoF)
constexpr int kLanes = 32;
constexpr int kAhead = SECOND_AHEAD;  // steps whose rows are in flight
// 'time1': n + 1 threads a lane (9 at 7 DoF). At 2048 lanes (the timeopt path), 16
// lanes a block are 128 blocks, one on each of 128 of the 132 SMs; 32 lanes
// a block, 64 blocks on 64 SMs, measured 1.1x (float32) and 1.3x (float64)
// slower.
constexpr int kTime1Lanes = TIME1_LANES;
constexpr int kTime1Ahead = TIME1_AHEAD;

// index of (i, j), i <= j, in a row-major upper triangle of an N x N matrix
template <int N>
__device__ __forceinline__ int tri(int i, int j) {
  return i * N - (i * (i - 1)) / 2 + (j - i);
}

// The two kinds as policies of one body: widths, lanes a block, threads a
// lane (kGroup, of which n + 1 own a column of [Qux | Qu]) and steps ahead.
template <int M_>
struct Second {
  static constexpr bool kSecond = true;
  static constexpr int M = M_, N = 2 * M_, DOF = M_;
  static constexpr int kLanes = ::kLanes, kGroup = N + 2, kAhead = ::kAhead;
};

template <int N_>
struct Time1 {
  static constexpr bool kSecond = false;
  static constexpr int M = N_, N = N_, DOF = N_ - 1;
  static constexpr int kLanes = kTime1Lanes, kGroup = N_ + 1,
                       kAhead = kTime1Ahead;
};

template <class K>
struct Layout {
  static constexpr int N = K::N, M = K::M;
  static constexpr int NX = N + 1;                 // columns of [Qux | Qu]
  static constexpr int kTri = N * (N + 1) / 2;
  static constexpr int kCarry = N * N + N;         // P (both halves), p
  static constexpr int kGain = M * NX;             // K | d
  static constexpr int kPiv = M * (M + 1);         // pivot columns, 1 / pivot
  static constexpr int kRows = 2 * N + M;          // U, lx, L2 of one step
  static constexpr int kVals =
      2 * kCarry + kGain + kPiv + (K::kAhead + 1) * kRows + kTri;
  // threads a block: whole warps
  static constexpr int kThreads = (K::kGroup * K::kLanes + 31) / 32 * 32;
};

// entry e of a shared buffer whose base already points at this thread's lane
#define SH(base, e) (base)[(e) * kL]

template <class Kind, typename T>
__device__ __forceinline__ void sweep(
    const T* __restrict__ P0, const T* __restrict__ p0,
    const T* __restrict__ L2, const T* __restrict__ lx,
    const T* __restrict__ U, const T* __restrict__ gxx,
    const int* __restrict__ slots, const T* __restrict__ params,
    T* __restrict__ Ks, T* __restrict__ ds, int Hm1, int B) {
  using L = Layout<Kind>;
  constexpr int M = Kind::M, N = Kind::N, DOF = Kind::DOF, NX = L::NX;
  constexpr int kL = Kind::kLanes, kG = Kind::kGroup, kAh = Kind::kAhead;
  static_assert(kG >= NX, "one thread a lane for each column of [Qux | Qu]");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x / kL;      // the column / row this thread owns
  const int l = threadIdx.x % kL;
  const int b = blockIdx.x * kL + l;
  const bool live = b < B;
  const int bl = live ? b : B - 1;     // the lane whose inputs are read
  const size_t sB = static_cast<size_t>(B);

  // The carry holds P in full, entry (i, j) at i * N + j, both halves
  // written with one value, so a column owner reads column c at a fixed
  // offset from a pointer it forms once a step; p follows at N * N.
  T* cur = reinterpret_cast<T*>(smem_raw) + l;  // carry of step t + 1
  T* nxt = cur + L::kCarry * kL;                // carry being written
  T* const Ksh = cur + 2 * L::kCarry * kL;      // [M][NX]: K | d
  T* const Psh = Ksh + L::kGain * kL;           // [M][M + 1]
  T* const Rsh = Psh + L::kPiv * kL;            // [kAh + 1][kRows]
  T* const Gsh = Rsh + (kAh + 1) * L::kRows * kL;  // [kTri]
  // row w of the keypoint Hessian's upper triangle: entry (w, j) at gw + j
  const int gw = tri<N>(w < N ? w : 0, 0);

  const T dt = params[0];
  const T b1 = params[1];  // dt^2 / 2, rounded once from double
  const T reg = params[2];

  // The streamed rows of a step (U, lx, L2: kRows rows) are copied into a
  // ring slot by rows w, w + kG, ...: this thread's source pointers, at the
  // last step, each moved back one step after a copy.
  constexpr int kMine = (L::kRows + kG - 1) / kG;
  const T* src[kMine];
  size_t back[kMine];
#pragma unroll
  for (int q = 0; q < kMine; ++q) {
    const int r = w + q * kG;
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
    T* const dst = Rsh + ring_in * L::kRows * kL;
#pragma unroll
    for (int q = 0; q < kMine; ++q) {
      if (w < kG && w + q * kG < L::kRows)
        __pipeline_memcpy_async(&SH(dst, w + q * kG), src[q], sizeof(T));
      src[q] -= back[q];
    }
    ring_in = ring_in == kAh ? 0 : ring_in + 1;
  };

  for (int s = 0; s < kAh; ++s) {
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
  __pipeline_wait_prior(kAh - 1);  // the rows of step Hm1 - 1 have landed
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
    if (t - kAh >= 0) copy_rows();
    __pipeline_commit();
    const T* const rows = Rsh + ring_out * L::kRows * kL;
    ring_out = ring_out == kAh ? 0 : ring_out + 1;
    const T* const pvec = cur + N * N * kL;  // p

    // 1. this thread's columns of the system [Quu + reg I | Qux | Qu], and
    // qc, its column of Qux, kept for the value update
    T x[M], qc[M], a[M];
#pragma unroll
    for (int r = 0; r < M; ++r) x[r] = qc[r] = a[r] = T(0);
    if constexpr (Kind::kSecond) {
      // With PA = P A (dt * q-columns added to the dq-columns), column c of
      // Qux = B^T PA is b1 PA[r][c] + dt PA[r + dof][c].
      if (w < DOF) {
        const T* const pc = cur + w * kL;  // P[:, w], entry a at a * N
#pragma unroll
        for (int r = 0; r < M; ++r)
          x[r] = qc[r] = b1 * SH(pc, r * N) + dt * SH(pc, (r + DOF) * N);
        const T* const pd = pc + DOF * kL;  // P[:, w + dof]
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
        const T* const pc = cur + w * kL;   // P[:, w]
        const T* const pq = pc - DOF * kL;  // P[:, w - dof]
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
    } else {
      // B from this step's control: s = u[m-1], h = 2 s, g = h u[:dof];
      // Qux = B^T P: row r < dof is s^2 P[r][c], the last row the
      // chain-rule sum g . P[:dof, c] + h P[n-1][c]
      if (w <= N) {
        T g[DOF];
        const T s = SH(rows, M - 1);
        const T dtk = s * s;
        const T h = T(2) * s;
#pragma unroll
        for (int q = 0; q < DOF; ++q) g[q] = h * SH(rows, q);
        if (w < N) {
          const T* const pc = cur + w * kL;  // P[:, w], entry a at a * N
          T acc = T(0);
#pragma unroll
          for (int r = 0; r < DOF; ++r) {
            const T v = SH(pc, r * N);
            qc[r] = dtk * v;
            acc += g[r] * v;
          }
          qc[DOF] = acc + h * SH(pc, DOF * N);
#pragma unroll
          for (int r = 0; r < M; ++r) x[r] = qc[r];
          // column w of P B: s^2 P[:, w], or for the last column
          // P g + h P[:, n-1], a row of P a sum
          T pb[N];
          if (w < DOF) {
#pragma unroll
            for (int r = 0; r < N; ++r) pb[r] = dtk * SH(pc, r * N);
          } else {
#pragma unroll
            for (int r = 0; r < N; ++r) {
              const T* const pr = cur + r * N * kL;  // P[r, :]
              T acc2 = T(0);
#pragma unroll
              for (int q = 0; q < DOF; ++q) acc2 += SH(pr, q) * g[q];
              pb[r] = acc2 + SH(pr, N - 1) * h;
            }
          }
          // column w of Quu = B^T (P B), the regularized diagonal
          T last = T(0);
#pragma unroll
          for (int q = 0; q < DOF; ++q) last += g[q] * pb[q];
          last = last + h * pb[N - 1];
#pragma unroll
          for (int i = 0; i < DOF; ++i) {
            T q = dtk * pb[i];
            if (i == w) q = q + params[3 + i] + reg;
            a[i] = q;
          }
          if (w == DOF) last = last + params[3 + DOF] + reg;
          a[DOF] = last;
        } else {
          T acc = T(0);
#pragma unroll
          for (int q = 0; q < DOF; ++q) acc += g[q] * SH(pvec, q);
#pragma unroll
          for (int i = 0; i < DOF; ++i)
            x[i] = params[3 + i] * SH(rows, i) + dtk * SH(pvec, i);
          x[DOF] = params[3 + DOF] * SH(rows, DOF) + (acc + h * SH(pvec, N - 1));
        }
      }
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

    // 4. value update: thread i writes row i (and, mirrored, column i) of
    // the other carry buffer, from its Qux column qc and its K column x
    if (w < N) {
      const int i = w;
      // 'second': a dq-row, where A^T adds dt * the q-row
      const bool low = Kind::kSecond && i >= DOF;
      const T* const pr = cur + i * N * kL;  // P[i, :]
      const T* const pq = low ? pr - DOF * N * kL : pr;  // P[i - dof, :]
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
      T* const nr = nxt + i * N * kL;  // new P[i, :]
      T* const nc = nxt + i * kL;      // new P[:, i]
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
        // 'second': PA[i][j], and for a dq-row dt * PA[i - dof][j] more
        T pa = !Kind::kSecond || j < DOF ? SH(pr, j)
                                         : SH(pr, j) + dt * SH(pr, j - DOF);
        if (low)
          pa = pa + dt * (j < DOF ? SH(pq, j)
                                  : SH(pq, j) + dt * SH(pq, j - DOF));
        const T v = ((stage + pa) + a1) - reg * a2;
        SH(nr, j) = v;
        SH(nc, j * N) = v;
      }
    }
    __pipeline_wait_prior(kAh - 1);  // the rows of step t - 1 have landed
    __syncthreads();
    T* const tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

#undef SH

#define SWEEP_ARGS                                                         \
  const T *__restrict__ P0, const T *__restrict__ p0,                      \
      const T *__restrict__ L2, const T *__restrict__ lx,                  \
      const T *__restrict__ U, const T *__restrict__ gxx,                  \
      const int *__restrict__ slots, const T *__restrict__ params,         \
      T *__restrict__ Ks, T *__restrict__ ds, int Hm1, int B

template <int M, typename T>
__global__ void __launch_bounds__(Layout<Second<M>>::kThreads)
second_kernel(SWEEP_ARGS) {
  sweep<Second<M>, T>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
}

template <int N, typename T>
__global__ void __launch_bounds__(Layout<Time1<N>>::kThreads)
time1_kernel(SWEEP_ARGS) {
  sweep<Time1<N>, T>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
}

#undef SWEEP_ARGS

// The kernel of a kind (second_kernel<7, T> or time1_kernel<8, T>) with its
// launch: blocks at batch B, threads a block, dynamic shared memory.
template <class Kind, typename T>
struct Launch {
  static constexpr int threads = Layout<Kind>::kThreads;
  static constexpr int smem =
      static_cast<int>(Layout<Kind>::kVals * Kind::kLanes * sizeof(T));
  static int blocks(int B) { return (B + Kind::kLanes - 1) / Kind::kLanes; }
  static auto kernel() {
    if constexpr (Kind::kSecond)
      return second_kernel<Kind::M, T>;
    else
      return time1_kernel<Kind::N, T>;
  }
};

template <class Kind, typename T>
int launch(const T* P0, const T* p0, const T* L2, const T* lx, const T* U,
           const T* gxx, const int* slots, const T* params, T* Ks, T* ds,
           int Hm1, int B, void* stream) {
  using G = Launch<Kind, T>;
  const auto kernel = G::kernel();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<G::blocks(B), G::threads, G::smem,
           static_cast<cudaStream_t>(stream)>>>(
      P0, p0, L2, lx, U, gxx, slots, params, Ks, ds, Hm1, B);
  return static_cast<int>(cudaGetLastError());
}

// (blocks, threads a block, dynamic shared memory, blocks the card holds on
// one SM) of a launch of the kind's kernel at batch B
template <class Kind, typename T>
int geometry(int B, int* out) {
  using G = Launch<Kind, T>;
  const auto kernel = G::kernel();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = G::blocks(B);
  out[1] = G::threads;
  out[2] = G::smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], kernel, G::threads, G::smem));
}

}  // namespace

// Plain C entry points for ctypes, named after this library's kind and
// width: segment_backward_second_m<m>_<type> or
// segment_backward_time1_n<n>_<type>. Arrays are contiguous with the lane
// axis minor: P0 [n,n,B], p0 [n,B], L2/lx [Hm1,n,B], U [Hm1,m,B],
// gxx [n_kp,n,n,B] (upper triangle read), slots [Hm1] (-1 off keypoints),
// params [3+m] = (dt, dt^2/2, reg, Rt); out Ks [Hm1,m,n,B], ds [Hm1,m,B]
// ('time1': dt unused). Each returns the CUDA error code of the launch.
#define SWEEP_ENTRY(NAME, KIND, T)                                            \
  extern "C" int NAME(const T* P0, const T* p0, const T* L2, const T* lx,     \
                      const T* U, const T* gxx, const int* slots,             \
                      const T* params, T* Ks, T* ds, int Hm1, int B,          \
                      void* stream) {                                         \
    return launch<KIND, T>(P0, p0, L2, lx, U, gxx, slots, params, Ks, ds,     \
                           Hm1, B, stream);                                   \
  }
// the names, one more level so that the width expands before ## pastes
#define SWEEP_NAME(KIND, W, TAG) segment_backward_##KIND##_##W##_##TAG
#define SWEEP_NAME_OF(KIND, W, TAG) SWEEP_NAME(KIND, W, TAG)
#define CAT(A, B) A##B
#define CAT_OF(A, B) CAT(A, B)

#ifdef SECOND_M
using Built = Second<SECOND_M>;
constexpr int kKind = 0, kWidth = SECOND_M;
SWEEP_ENTRY(SWEEP_NAME_OF(second, CAT_OF(m, SECOND_M), f32), Built, float)
SWEEP_ENTRY(SWEEP_NAME_OF(second, CAT_OF(m, SECOND_M), f64), Built, double)
#else
using Built = Time1<TIME1_N>;
constexpr int kKind = 1, kWidth = TIME1_N;
SWEEP_ENTRY(SWEEP_NAME_OF(time1, CAT_OF(n, TIME1_N), f32), Built, float)
SWEEP_ENTRY(SWEEP_NAME_OF(time1, CAT_OF(n, TIME1_N), f64), Built, double)
#endif

// The launch geometry of a kind (0 'second', 1 'time1') and width (m for
// 'second', n for 'time1') at batch B for an element of `itemsize` bytes
// (4 or 8) -> out[4] = (blocks, threads a block, dynamic shared memory in
// bytes, resident blocks an SM by the CUDA occupancy calculator). Returns a
// CUDA error code; 1 (cudaErrorInvalidValue) for a kind or width that is not
// this library's.
extern "C" int segment_backward_2nd_geometry(int kind, int width, int itemsize,
                                             int B, int* out) {
  if (kind != kKind || width != kWidth) return 1;
  return itemsize == 4 ? geometry<Built, float>(B, out)
                       : geometry<Built, double>(B, out);
}
