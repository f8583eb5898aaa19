// Fused dense quadratization + Riccati backward sweep of the recursive iLQR
// solver for the structured first-order kinds (A = I, B = dt I), for Hopper
// (sm_90a).
//
// Replaces ilqr_planner_tpu/ops/pallas_kernels/riccati.py::
// riccati_backward_structured (body `_kernel`). At EVERY step t, from H-1
// down to 0, for every scenario lane:
//   QJ = prec_t J,  Qe = prec_t e
//   l_xx = J^T QJ + diag(ld^2),  l_x = -J^T Qe - ld lq
// step H-1 seeds the cost-to-go (P, p) = (l_xx, l_x); every earlier step does
//   Quu_reg = dt^2 P + diag(Rt + reg),  Qux = dt P
//   Qu = Rt u + dt p,  Qx = l_x + p
//   M^-1 by Gauss-Jordan without pivoting (explicit inverse, as the TPU body)
//   K = -M^-1 Qux,  d = -M^-1 Qu
//   Quu = Quu_reg - reg I                         (the UNregularized Quu)
//   P' = l_xx + P + K^T Quu K + K^T Qux + Qux^T K
//   p' = Qx + K^T Quu d + K^T Qu + Qux^T d
// and writes K, d. The sums run in the order of the plain twin
// (riccati_backward_reference), so float64 differs from it by rounding only.
// A step whose precision is all zero is not skipped: a residual at every step
// is this kernel's contract. Widths: any chain n and any residual width nq
// (6 posorn, n joint, 3 point, 2 planar point, and the sums of a sequential
// spec's subsystems, up to the wrapper's MAX_NQ), float32 and float64, one
// library a width.
//
// What bounds it on the H100: by its bytes, memory (each step streams
// nq n + nq + 3 n values in and n n + n out a lane, about 0.5 KB in float32,
// against about 7 kFLOP); in practice the serial chain of each lane. The
// first design (one thread a lane, every per-lane matrix in shared memory,
// each step's rows copied in before its algebra) took 52 us a step at
// B = 4096: one warp on each of 128 SMs, every operand a dependent load.
//
// The design: several threads a lane, split over output columns, never
// over a summation index, so that every sum runs in one thread in the
// twin's order (the recursion doubles the antisymmetric rounding residue of
// P wherever dt^2 P dominates Rt, so a reordered sum would show as a worse
// float64 error, not as noise).
//  * A block owns kLanes neighbouring lanes and runs n + 1 threads a lane:
//    thread (w, lane), w = threadIdx.x / kLanes. At 32 lanes a warp is 32
//    lanes on one matrix entry, and the [entry][lane] buffers are free of
//    bank conflicts. Thread w < n owns column w of QJ, l_xx, the system
//    [Quu_reg | I] through the elimination, K, and P', and row w of K^T Quu;
//    thread n owns the vectors Qe, l_x, Qu, Qx, d and p'. All of these live
//    in the owner's registers; what another thread reads goes through
//    shared memory.
//  * The elimination is column-separable: at pivot k the owner of column k
//    publishes it and 1 / pivot, one barrier later every column owner
//    updates its columns of the system and of the inverse, and each entry
//    sees "scale row k, subtract f_r x row k" in the twin's order. The
//    owners then store the inverse's columns (barrier), form K's column and
//    K^T Quu's row (K's column is theirs, so no barrier between), store both
//    (barrier), and form P''s column. Ten barriers a step.
//  * The carry (P in full, p) lives in shared memory [entry][lane], two
//    copies in turn, because every owner reads across it; the inverse is
//    stored in the copy being written (dead until P' is formed), K^T Quu in
//    the pivot columns' place.
//  * Inputs in flight, in chunks: a lane's rows of kSteps consecutive steps
//    are one contiguous run an array (kSteps nq n values of J, and so on);
//    each chunk is staged by cp.async into one of two shared tiles
//    [lane][odd stride] while the other is computed, neighbouring threads
//    on neighbouring values of a lane's run (whole sectors, coalesced), the
//    odd stride keeping the per-lane reads free of bank conflicts; the
//    chunk's precisions (the same for every lane) come with it. The copies
//    are one element each (4 or 8 bytes): a row of J, e, ld, lq or u starts
//    at a multiple of 42, 6, 7 or 7 values, so no wider copy is aligned in
//    general. The next chunk's copies must have landed by the barrier that
//    ends the current chunk.
//  * Outputs out in chunks: each step's K (by its column owners) and d go to
//    a shared tile [lane][odd stride]; after the barrier that ends a chunk
//    every thread copies the chunk's K and d out as one contiguous run a
//    lane and array (kSteps n n and kSteps n values).
//  * Shared memory a lane: two input chunks 2 (kSteps (nq n + nq + 3 n) | 1),
//    the gains' chunk kSteps (n n + n) | 1, two carries 2 (n n + n), the
//    pivot columns n (n + 1); the chunk's precisions ride along as a few
//    values a lane. At kSteps = 1 (the default) and nq = 6: 366 values,
//    46,848 bytes a block of 32 lanes in float32 and 93,696 in float64 (nq =
//    7: 49,024 / 98,048; nq = 3: 40,448 / 80,896), so shared memory alone
//    would leave 4 blocks (128 lanes) an SM in float32 and 2 (64) in
//    float64. Registers decide: the copy loops are rolled (unrolled, ptxas
//    kept their addresses in registers: 196-255 a thread, 1 block an SM,
//    and spills in two float32 widths), which leaves 128 registers a thread
//    in float32, 2 blocks (64 lanes) an SM, and 168-240 in float64, 1 block
//    (32 lanes), no spill. At B = 4096 (128 blocks) every SM holds one
//    block either way; at B = 36864 (1152 blocks) float32 runs 2 blocks an
//    SM. What was measured on an NVIDIA H100 80GB HBM3 at 700 W
//    (tools/kernel_variants.py, float32 / float64, B = 4096; B = 36864):
//    this design 0.405 / 0.552 ms; 2.480 / 4.865 (the first design 4.87 /
//    6.84; 14.9 / 34.4). Chunks of 2 steps: the same in float32, 0.69 and
//    6.08 in float64 (143 KB a block); 16 lanes a block: 1.2x slower; the
//    loops over a thread's rows or columns rolled: 1.2x slower; registers
//    capped by __launch_bounds__ to fit 2-3 blocks an SM: spills, 1.6-2.5x
//    slower.
//    What is left (about 4 us a step at B = 4096): ten barriers a step and
//    about 1100 instructions a thread between them, 8 warps an SM.
//  * A ragged last block: lanes past B read lane B - 1 and store nothing; no
//    thread leaves before the last barrier.
// Tensor cores (wgmma) are not the tool: the products are 7 x 7 a lane
// inside a serial recursion, and float32 / float64 accuracy is part of the
// result. TMA is not used: the runs are a few hundred bytes a lane, not
// tiles.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// The width: n (the chain's DoF) and nq (the residual: 6 position +
// orientation, n joint, 3 point, 2 planar point, or a sequential spec's sum
// of them), one library a width, built at first use.
#if !defined(RICCATI_N) || !defined(RICCATI_NQ)
#error "build with -DRICCATI_N=<n> -DRICCATI_NQ=<nq>"
#endif
#ifndef RICCATI_LANES
#define RICCATI_LANES 32
#endif
#ifndef RICCATI_STEPS
#define RICCATI_STEPS 1
#endif
constexpr int kLanes = RICCATI_LANES;  // lanes a block
constexpr int kSteps = RICCATI_STEPS;  // steps a staged chunk

template <int N, int NQ>
struct Layout {
  static constexpr int kThreads = (N + 1) * kLanes;  // n + 1 threads a lane
  // a lane's run of a chunk, [lane][odd stride]: J, e, ld, lq, u
  static constexpr int kE = kSteps * NQ * N;
  static constexpr int kLd = kE + kSteps * NQ;
  static constexpr int kLq = kLd + kSteps * N;
  static constexpr int kU = kLq + kSteps * N;
  static constexpr int kInStride = (kU + kSteps * N) | 1;
  // a lane's gains of a chunk, [lane][odd stride]: K, then d
  static constexpr int kOutD = kSteps * N * N;
  static constexpr int kOutStride = (kOutD + kSteps * N) | 1;
  // [entry][lane]: two carries (P in full, p), the pivot columns
  static constexpr int kCarry = N * N + N;
  static constexpr int kPiv = N * (N + 1);
  // the chunk's precisions, two buffers, in values a lane (rounded up)
  static constexpr int kPrec = (2 * kSteps * NQ * NQ + kLanes - 1) / kLanes;
  static constexpr int kVals =
      2 * kInStride + kOutStride + 2 * kCarry + kPiv + kPrec;  // a lane
  static constexpr int kSmem = kVals * kLanes;                   // a block
};

// Copy a run of `count` values a lane (W a step at most kSteps steps) of
// every lane of the block by cp.async: lane l's run starts at
// src + run(lane) and goes to dst + l * stride; thread tid takes the values
// tid, tid + kT, ... of the block's [lane][kSteps * W] index space.
template <int W, int kT, typename T, typename Run>
__device__ __forceinline__ void runs_in(T* dst, int stride, const T* src,
                                        Run run, int count, int tid) {
  constexpr int kAll = kLanes * kSteps * W;
#pragma unroll 1
  for (int q = 0; q < (kAll + kT - 1) / kT; ++q) {
    const int idx = tid + q * kT;
    const int l = idx / (kSteps * W), c = idx - l * (kSteps * W);
    if (idx < kAll && c < count)
      __pipeline_memcpy_async(dst + l * stride + c, src + run(l) + c,
                              sizeof(T));
  }
}

// The inverse of runs_in for the live lanes (l < lanes), plain loads and
// stores.
template <int W, int kT, typename T, typename Run>
__device__ __forceinline__ void runs_out(T* dst, Run run, const T* src,
                                         int stride, int count, int lanes,
                                         int tid) {
  constexpr int kAll = kLanes * kSteps * W;
#pragma unroll 1
  for (int q = 0; q < (kAll + kT - 1) / kT; ++q) {
    const int idx = tid + q * kT;
    const int l = idx / (kSteps * W), c = idx - l * (kSteps * W);
    if (idx < kAll && c < count && l < lanes)
      dst[run(l) + c] = src[l * stride + c];
  }
}

template <int N, int NQ, typename T>
__global__ void __launch_bounds__(Layout<N, NQ>::kThreads)
riccati_kernel(const T* __restrict__ J, const T* __restrict__ e,
               const T* __restrict__ ld, const T* __restrict__ lq,
               const T* __restrict__ u, const T* __restrict__ prec,
               const T* __restrict__ params, T* __restrict__ K,
               T* __restrict__ d, int H, int B) {
  using L = Layout<N, NQ>;
  constexpr int NN = N * N;
  constexpr int kT = L::kThreads;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const tin = reinterpret_cast<T*>(smem_raw);  // [2][kLanes][kInStride]
  T* const tout = tin + 2 * kLanes * L::kInStride;  // [kLanes][kOutStride]
  T* const priv = tout + kLanes * L::kOutStride;    // [entry][lane]
  T* const precs = priv + (2 * L::kCarry + L::kPiv) * kLanes;  // [2][kSteps][NQ NQ]

  const int tid = threadIdx.x;
  const int w = tid / kLanes;  // owner: column w < N, or the vectors (N)
  const int l = tid % kLanes;
  const int b0 = blockIdx.x * kLanes;
  const int lanes = B - b0 < kLanes ? B - b0 : kLanes;  // live lanes
  const size_t sH = static_cast<size_t>(H);
  const size_t sHm1 = static_cast<size_t>(H - 1);
  // the first row of lane l's arrays (lanes past B read lane B - 1)
  auto lane_of = [&](int ll) -> size_t {
    return static_cast<size_t>(ll < lanes ? b0 + ll : B - 1);
  };

#define SH(base, i) (base)[(i) * kLanes]
  T* Pc = priv + l;                   // carry of step t + 1: P, then p at NN
  T* Pn = Pc + L::kCarry * kLanes;    // carry being written; the inverse
  T* const Vsh = Pc + 2 * L::kCarry * kLanes;  // pivot columns; K^T Quu

  const T dt = params[0];
  const T reg = params[1];
  const T dt2 = dt * dt;
  const T* const Rt = params + 2;
  T rr[N];  // the diagonal Rt + reg of Quu_reg
#pragma unroll
  for (int i = 0; i < N; ++i) rr[i] = Rt[i] + reg;

  // chunk c holds steps lo .. hi, hi = H - 1 - c kSteps
  auto bounds = [&](int c, int& lo, int& hi) {
    hi = H - 1 - c * kSteps;
    lo = hi - kSteps + 1 > 0 ? hi - kSteps + 1 : 0;
  };
  auto stage = [&](int c) {  // chunk c -> input tile c & 1, by cp.async
    int lo, hi;
    bounds(c, lo, hi);
    const int cnt = hi - lo + 1;                    // steps of J, e, ld, lq
    const int cu = (hi < H - 2 ? hi : H - 2) - lo + 1;  // of u (none at H-1)
    T* const dst = tin + (c & 1) * kLanes * L::kInStride;
    runs_in<NQ * N, kT>(dst, L::kInStride, J,
                        [&](int ll) { return (lane_of(ll) * sH + lo) * (NQ * N); },
                        cnt * NQ * N, tid);
    runs_in<NQ, kT>(dst + L::kE, L::kInStride, e,
                    [&](int ll) { return (lane_of(ll) * sH + lo) * NQ; },
                    cnt * NQ, tid);
    runs_in<N, kT>(dst + L::kLd, L::kInStride, ld,
                   [&](int ll) { return (lane_of(ll) * sH + lo) * N; }, cnt * N,
                   tid);
    runs_in<N, kT>(dst + L::kLq, L::kInStride, lq,
                   [&](int ll) { return (lane_of(ll) * sH + lo) * N; }, cnt * N,
                   tid);
    runs_in<N, kT>(dst + L::kU, L::kInStride, u,
                   [&](int ll) { return (lane_of(ll) * sHm1 + lo) * N; },
                   cu * N, tid);
    T* const pdst = precs + (c & 1) * kSteps * NQ * NQ;
    for (int i = tid; i < cnt * NQ * NQ; i += kT)
      __pipeline_memcpy_async(pdst + i, prec + static_cast<size_t>(lo) * NQ * NQ + i,
                              sizeof(T));
  };
  auto write_out = [&](int c) {  // chunk c's gains, out of the tile
    int lo, hi;
    bounds(c, lo, hi);
    const int ck = (hi < H - 2 ? hi : H - 2) - lo + 1;  // steps with gains
    runs_out<NN, kT>(K, [&](int ll) { return (lane_of(ll) * sHm1 + lo) * NN; },
                     tout, L::kOutStride, ck * NN, lanes, tid);
    runs_out<N, kT>(d, [&](int ll) { return (lane_of(ll) * sHm1 + lo) * N; },
                    tout + L::kOutD, L::kOutStride, ck * N, lanes, tid);
  };

  const int chunks = (H + kSteps - 1) / kSteps;
  stage(0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

#pragma unroll 1
  for (int c = 0; c < chunks; ++c) {
    int lo, hi;
    bounds(c, lo, hi);
    if (c + 1 < chunks) stage(c + 1);
    __pipeline_commit();
    if (c > 0) write_out(c - 1);  // past the barrier that ended chunk c - 1
    const T* const in = tin + (c & 1) * kLanes * L::kInStride + l * L::kInStride;
    T* const out = tout + l * L::kOutStride;

#pragma unroll 1
    for (int t = hi; t >= lo; --t) {
      const int s = t - lo;
      const T* const Jt = in + s * NQ * N;  // J[a][i] at a * N + i
      const T* const et = in + L::kE + s * NQ;
      const T* const ldt = in + L::kLd + s * N;
      const T* const lqt = in + L::kLq + s * N;
      const T* const ut = in + L::kU + s * N;
      const T* const pr = precs + ((c & 1) * kSteps + s) * NQ * NQ;
      T* const Kt = out + s * NN;  // K[i][j] at i * N + j
      T* const dout = out + L::kOutD + s * N;

      // 1. stage terms: column w of QJ and of l_xx; or Qe and l_x
      T lxx[N], vx[N];
      if (w < N) {
        T qj[NQ];
#pragma unroll
        for (int a = 0; a < NQ; ++a) {
          T acc = pr[a * NQ] * Jt[w];
#pragma unroll
          for (int q = 1; q < NQ; ++q) acc = acc + pr[a * NQ + q] * Jt[q * N + w];
          qj[a] = acc;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          T acc = Jt[i] * qj[0];
#pragma unroll
          for (int a = 1; a < NQ; ++a) acc = acc + Jt[a * N + i] * qj[a];
          if (i == w) acc = acc + ldt[i] * ldt[i];
          lxx[i] = acc;
        }
      } else if (w == N) {
        T qe[NQ];
#pragma unroll
        for (int a = 0; a < NQ; ++a) {
          T acc = pr[a * NQ] * et[0];
#pragma unroll
          for (int q = 1; q < NQ; ++q) acc = acc + pr[a * NQ + q] * et[q];
          qe[a] = acc;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          T acc = Jt[i] * qe[0];
#pragma unroll
          for (int a = 1; a < NQ; ++a) acc = acc + Jt[a * N + i] * qe[a];
          vx[i] = -acc - ldt[i] * lqt[i];
        }
      }

      if (t == H - 1) {
        // terminal step: (P, p) = (l_xx, l_x)
        if (w < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) SH(Pn, i * N + w) = lxx[i];
        } else if (w == N) {
#pragma unroll
          for (int i = 0; i < N; ++i) SH(Pn, NN + i) = vx[i];
        }
      } else {
        // 2. column w of the system Quu_reg and of the identity; Qu, Qx
        T a[N], m[N], qu[N], qx[N], qc[N];
        if (w < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            T q = dt2 * SH(Pc, i * N + w);
            if (i == w) q = q + rr[i];
            a[i] = q;
            m[i] = i == w ? T(1) : T(0);
          }
        } else if (w == N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            qu[i] = Rt[i] * ut[i] + dt * SH(Pc, NN + i);
            qx[i] = vx[i] + SH(Pc, NN + i);
          }
        }

        // 3. Gauss-Jordan without pivoting: the system -> I, the identity
        // -> Quu_reg^-1; a barrier a pivot
#pragma unroll
        for (int k = 0; k < N; ++k) {
          if (w == k) {
#pragma unroll
            for (int i = 0; i < N; ++i) SH(Vsh, k * (N + 1) + i) = a[i];
            SH(Vsh, k * (N + 1) + N) = T(1) / a[k];
          }
          __syncthreads();
          if (w < N) {
            T fac[N];
#pragma unroll
            for (int r = 0; r < N; ++r) fac[r] = SH(Vsh, k * (N + 1) + r);
            const T piv = SH(Vsh, k * (N + 1) + N);
            m[k] = m[k] * piv;
#pragma unroll
            for (int r = 0; r < N; ++r)
              if (r != k) m[r] = m[r] - fac[r] * m[k];
            if (w > k) {
              a[k] = a[k] * piv;
#pragma unroll
              for (int r = 0; r < N; ++r)
                if (r != k) a[r] = a[r] - fac[r] * a[k];
            }
          }
        }
        // the inverse's column w, in the carry being written (dead until
        // the value update)
        if (w < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) SH(Pn, i * N + w) = m[i];
        }
        __syncthreads();

        // 4. gains into the tile: column w of K = (-M^-1) Qux, then row w
        // of K^T Quu with the unregularized Quu rebuilt from the carry; or
        // d = (-M^-1) Qu
        T kc[N];
        if (w < N) {
#pragma unroll
          for (int s2 = 0; s2 < N; ++s2) qc[s2] = dt * SH(Pc, s2 * N + w);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            T acc = -SH(Pn, i * N) * qc[0];
#pragma unroll
            for (int s2 = 1; s2 < N; ++s2)
              acc = acc + -SH(Pn, i * N + s2) * qc[s2];
            kc[i] = acc;
            Kt[i * N + w] = acc;
          }
#pragma unroll
          for (int j = 0; j < N; ++j) {
            T acc = T(0);
#pragma unroll
            for (int s2 = 0; s2 < N; ++s2) {
              T q = dt2 * SH(Pc, s2 * N + j);
              if (s2 == j) q = (q + rr[s2]) - reg;
              const T term = kc[s2] * q;
              acc = s2 == 0 ? term : acc + term;
            }
            SH(Vsh, w * N + j) = acc;
          }
        } else if (w == N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            T acc = -SH(Pn, i * N) * qu[0];
#pragma unroll
            for (int s2 = 1; s2 < N; ++s2)
              acc = acc + -SH(Pn, i * N + s2) * qu[s2];
            kc[i] = acc;  // d
            dout[i] = acc;
          }
        }
        __syncthreads();

        // 5. the value update: column w of P', or p'
        if (w < N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            T a1 = SH(Vsh, i * N) * kc[0];           // K^T Quu K
            T a2 = Kt[i] * qc[0];                    // K^T Qux
            T a3 = (dt * SH(Pc, i)) * kc[0];         // Qux^T K
#pragma unroll
            for (int s2 = 1; s2 < N; ++s2) {
              a1 = a1 + SH(Vsh, i * N + s2) * kc[s2];
              a2 = a2 + Kt[s2 * N + i] * qc[s2];
              a3 = a3 + (dt * SH(Pc, s2 * N + i)) * kc[s2];
            }
            SH(Pn, i * N + w) =
                (((lxx[i] + SH(Pc, i * N + w)) + a1) + a2) + a3;
          }
        } else if (w == N) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            T b1 = SH(Vsh, i * N) * kc[0];           // K^T Quu d
            T b2 = Kt[i] * qu[0];                    // K^T Qu
            T b3 = (dt * SH(Pc, i)) * kc[0];         // Qux^T d
#pragma unroll
            for (int s2 = 1; s2 < N; ++s2) {
              b1 = b1 + SH(Vsh, i * N + s2) * kc[s2];
              b2 = b2 + Kt[s2 * N + i] * qu[s2];
              b3 = b3 + (dt * SH(Pc, s2 * N + i)) * kc[s2];
            }
            SH(Pn, NN + i) = ((qx[i] + b1) + b2) + b3;
          }
        }
      }
      if (t == lo) __pipeline_wait_prior(0);  // the next chunk has landed
      __syncthreads();
      T* const tmp = Pc;
      Pc = Pn;
      Pn = tmp;
    }
  }
  write_out(chunks - 1);
#undef SH
}

template <int N, int NQ, typename T>
constexpr int smem_bytes() {
  return static_cast<int>(Layout<N, NQ>::kSmem * sizeof(T));
}

template <int N, int NQ, typename T>
int launch(const T* J, const T* e, const T* ld, const T* lq, const T* u,
           const T* prec, const T* params, T* K, T* d, int H, int B,
           void* stream) {
  constexpr int smem = smem_bytes<N, NQ, T>();
  cudaError_t err = cudaFuncSetAttribute(
      riccati_kernel<N, NQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kLanes - 1) / kLanes;
  riccati_kernel<N, NQ, T><<<blocks, Layout<N, NQ>::kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      J, e, ld, lq, u, prec, params, K, d, H, B);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int NQ, typename T>
int geometry(int B, int* out) {
  constexpr int smem = smem_bytes<N, NQ, T>();
  cudaError_t err = cudaFuncSetAttribute(
      riccati_kernel<N, NQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = (B + kLanes - 1) / kLanes;
  out[1] = Layout<N, NQ>::kThreads;
  out[2] = smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], riccati_kernel<N, NQ, T>, Layout<N, NQ>::kThreads, smem));
}

}  // namespace

// Plain C entry points for ctypes: this library's width (n x nq), the
// RICCATI_N and RICCATI_NQ it was built with, in both types.
// Contiguous batch-leading arrays: J [B,H,nq,n], e [B,H,nq], ld/lq [B,H,n],
// u [B,H-1,n], prec [H,nq,nq], params [2+n] = (dt, reg, Rt); out
// K [B,H-1,n,n], d [B,H-1,n]; H >= 2, B >= 1. Each returns the CUDA error
// code of the launch.
#define RICCATI_ENTRY(N, NQ, T, TAG)                                           \
  extern "C" int riccati_backward_##N##x##NQ##_##TAG(                          \
      const T* J, const T* e, const T* ld, const T* lq, const T* u,            \
      const T* prec, const T* params, T* K, T* d, int H, int B,                \
      void* stream) {                                                          \
    return launch<N, NQ, T>(J, e, ld, lq, u, prec, params, K, d, H, B,         \
                            stream);                                           \
  }
// one more level, so that RICCATI_N and RICCATI_NQ expand before ## pastes
#define RICCATI_ENTRY_OF(N, NQ, T, TAG) RICCATI_ENTRY(N, NQ, T, TAG)

RICCATI_ENTRY_OF(RICCATI_N, RICCATI_NQ, float, f32)
RICCATI_ENTRY_OF(RICCATI_N, RICCATI_NQ, double, f64)

// The launch geometry of width (n, nq) at batch B for an element of
// `itemsize` bytes (4 or 8) -> out[4] = (blocks, threads a block, dynamic
// shared memory in bytes, resident blocks an SM by the CUDA occupancy
// calculator). Returns a CUDA error code; 1 (cudaErrorInvalidValue) for a
// width that is not this library's.
extern "C" int riccati_geometry(int n, int nq, int itemsize, int B, int* out) {
  if (n != RICCATI_N || nq != RICCATI_NQ) return 1;
  return itemsize == 4 ? geometry<RICCATI_N, RICCATI_NQ, float>(B, out)
                       : geometry<RICCATI_N, RICCATI_NQ, double>(B, out);
}
