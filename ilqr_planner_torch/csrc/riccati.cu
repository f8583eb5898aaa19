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
// is this kernel's contract.
//
// Layout: the arrays are batch-leading, as the solver makes them and as the
// JAX function takes them (J [B,H,nq,n], ... -> K [B,H-1,n,n]); no array is
// transposed before or after the launch. One warp is one block of 32 lanes.
// Per step the warp copies its lanes' rows (nq n + nq + 3 n values a lane,
// contiguous per lane) into a shared tile [lane][odd stride] with neighbouring
// threads on neighbouring addresses of one lane's row, then each thread works
// on its own lane out of shared memory; K and d go out the same way through a
// second tile. The odd strides keep both the copy and the per-lane reads free
// of bank conflicts.
//
// What bounds it on the H100: by its bytes, memory (each step streams
// nq n + nq + 3 n values in and n n + n out a lane, about 0.5 KB in float32,
// against about 7 kFLOP); but the recursion is a serial chain per lane and
// B = 4096 lanes are one warp on each of 128 SMs, so latency (shared-memory
// operands, dependent sums, the un-overlapped copy of each step's rows) is
// what this first design meets.
//
// What the design does about registers: the 7x7 carry (two copies), the 7x14
// elimination and the stage terms do not fit in registers beside each other,
// so every per-lane matrix and vector lives in shared memory laid out
// [entry][thread] (conflict-free) and the loops over rows stay rolled. About
// 47 KB a block in float32, 95 KB in float64 (opted in above 48 KB). QJ shares
// the inverse's buffer, K^T Quu the eliminated system's. Prefetching the next
// step's rows, several threads a lane and TMA are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

template <int N, int NQ>
struct Layout {
  static constexpr int kNN = N * N;
  // in-tile columns: J, e, ld, lq, u
  static constexpr int kE = NQ * N;
  static constexpr int kLd = kE + NQ;
  static constexpr int kLq = kLd + N;
  static constexpr int kU = kLq + N;
  static constexpr int kIn = kU + N;
  static constexpr int kInStride = kIn | 1;    // odd: no bank conflicts
  static constexpr int kOut = kNN + N;         // K, d
  static constexpr int kOutStride = kOut | 1;
  // per-thread buffers: P (two copies), the system, the inverse;
  // p (two copies), l_x, Qu, Qx, Qe
  static constexpr int kPriv = 4 * kNN + 5 * N + NQ;
  static constexpr int kVals = kInStride + kOutStride + kPriv;  // a lane
};

// Copy W contiguous values of each of `lanes` rows between global memory
// (row l at g + l * g_stride) and a shared tile (row l at s + l * s_stride).
template <int W, typename T>
__device__ __forceinline__ void rows_in(T* s, int s_stride, const T* g,
                                        size_t g_stride, int lanes, int tid) {
#pragma unroll 4
  for (int idx = tid; idx < lanes * W; idx += kThreads) {
    const int l = idx / W, c = idx - l * W;
    s[l * s_stride + c] = g[l * g_stride + c];
  }
}

template <int W, typename T>
__device__ __forceinline__ void rows_out(T* g, size_t g_stride, const T* s,
                                         int s_stride, int lanes, int tid) {
#pragma unroll 4
  for (int idx = tid; idx < lanes * W; idx += kThreads) {
    const int l = idx / W, c = idx - l * W;
    g[l * g_stride + c] = s[l * s_stride + c];
  }
}

template <int N, int NQ, typename T>
__global__ void __launch_bounds__(kThreads)
riccati_kernel(const T* __restrict__ J, const T* __restrict__ e,
               const T* __restrict__ ld, const T* __restrict__ lq,
               const T* __restrict__ u, const T* __restrict__ prec,
               const T* __restrict__ params, T* __restrict__ K,
               T* __restrict__ d, int H, int B) {
  using L = Layout<N, NQ>;
  constexpr int NN = L::kNN;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const tin = reinterpret_cast<T*>(smem_raw);   // [kThreads][kInStride]
  T* const tout = tin + kThreads * L::kInStride;   // [kThreads][kOutStride]
  T* const priv = tout + kThreads * L::kOutStride;  // [kPriv][kThreads]

  const int tid = threadIdx.x;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * kThreads;
  const int left = B - static_cast<int>(b0);
  const int lanes = left < kThreads ? left : kThreads;
  const bool active = tid < lanes;
  const size_t sH = static_cast<size_t>(H);
  const size_t sHm1 = static_cast<size_t>(H - 1);

  // this thread's rows of the two tiles, and its [entry][thread] buffers
  const T* const in = tin + tid * L::kInStride;
  T* const out = tout + tid * L::kOutStride;
  T* const mine = priv + tid;
#define SH(base, idx) (base)[(idx) * kThreads]
  T* Pc = mine;                       // carry of step t + 1
  T* Pn = mine + NN * kThreads;       // carry being written (first: l_xx)
  T* const Ash = mine + 2 * NN * kThreads;
  T* const Msh = mine + 3 * NN * kThreads;
  T* pc = mine + 4 * NN * kThreads;
  T* pn = pc + N * kThreads;
  T* const lxs = pn + N * kThreads;
  T* const Qus = lxs + N * kThreads;
  T* const Qxs = Qus + N * kThreads;
  T* const Qes = Qxs + N * kThreads;

  const T dt = params[0];
  const T reg = params[1];
  const T dt2 = dt * dt;
  const T* const Rt = params + 2;

#pragma unroll 1
  for (int t = H - 1; t >= 0; --t) {
    // 0. this step's rows of the block's lanes -> the in-tile
    const size_t row = b0 * sH + t;       // lane l: row + l * H
    rows_in<NQ * N>(tin, L::kInStride, J + row * (NQ * N), sH * (NQ * N),
                    lanes, tid);
    rows_in<NQ>(tin + L::kE, L::kInStride, e + row * NQ, sH * NQ, lanes, tid);
    rows_in<N>(tin + L::kLd, L::kInStride, ld + row * N, sH * N, lanes, tid);
    rows_in<N>(tin + L::kLq, L::kInStride, lq + row * N, sH * N, lanes, tid);
    if (t < H - 1)
      rows_in<N>(tin + L::kU, L::kInStride, u + (b0 * sHm1 + t) * N, sHm1 * N,
                 lanes, tid);
    __syncwarp();

    if (active) {
      // 1. stage terms. QJ -> Msh (free until the inverse), Qe
      const T* const pr = prec + static_cast<size_t>(t) * NQ * NQ;
#pragma unroll 1
      for (int a = 0; a < NQ; ++a) {
        T w[NQ];
#pragma unroll
        for (int c = 0; c < NQ; ++c) w[c] = pr[a * NQ + c];
#pragma unroll 1
        for (int i = 0; i < N; ++i) {
          T acc = w[0] * in[i];
#pragma unroll
          for (int c = 1; c < NQ; ++c) acc = acc + w[c] * in[c * N + i];
          SH(Msh, a * N + i) = acc;
        }
        T acc = w[0] * in[L::kE];
#pragma unroll
        for (int c = 1; c < NQ; ++c) acc = acc + w[c] * in[L::kE + c];
        SH(Qes, a) = acc;
      }
      // l_xx -> Pn, l_x -> lxs
#pragma unroll 1
      for (int i = 0; i < N; ++i) {
        const T ldi = in[L::kLd + i];
#pragma unroll 1
        for (int j = 0; j < N; ++j) {
          T acc = in[i] * SH(Msh, j);
#pragma unroll
          for (int a = 1; a < NQ; ++a)
            acc = acc + in[a * N + i] * SH(Msh, a * N + j);
          if (i == j) acc = acc + ldi * ldi;
          SH(Pn, i * N + j) = acc;
        }
        T acc = in[i] * SH(Qes, 0);
#pragma unroll
        for (int a = 1; a < NQ; ++a) acc = acc + in[a * N + i] * SH(Qes, a);
        SH(lxs, i) = -acc - ldi * in[L::kLq + i];
      }

      if (t == H - 1) {
        // terminal step: (P, p) = (l_xx, l_x)
#pragma unroll
        for (int i = 0; i < N; ++i) SH(pn, i) = SH(lxs, i);
      } else {
        // 2. the system Quu_reg -> Ash, the identity -> Msh, Qu, Qx
#pragma unroll 1
        for (int i = 0; i < N; ++i) {
          const T ri = Rt[i];
#pragma unroll
          for (int j = 0; j < N; ++j) {
            T q = dt2 * SH(Pc, i * N + j);
            if (i == j) q = q + (ri + reg);
            SH(Ash, i * N + j) = q;
            SH(Msh, i * N + j) = i == j ? T(1) : T(0);
          }
          SH(Qus, i) = ri * in[L::kU + i] + dt * SH(pc, i);
          SH(Qxs, i) = SH(lxs, i) + SH(pc, i);
        }

        // 3. Gauss-Jordan without pivoting: Ash -> I, Msh -> Quu_reg^-1
#pragma unroll 1
        for (int k = 0; k < N; ++k) {
          const T piv = T(1) / SH(Ash, k * N + k);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            SH(Ash, k * N + j) = SH(Ash, k * N + j) * piv;
            SH(Msh, k * N + j) = SH(Msh, k * N + j) * piv;
          }
#pragma unroll 1
          for (int r = 0; r < N; ++r) {
            if (r == k) continue;
            const T f = SH(Ash, r * N + k);
#pragma unroll
            for (int j = 0; j < N; ++j) {
              SH(Ash, r * N + j) = SH(Ash, r * N + j) - f * SH(Ash, k * N + j);
              SH(Msh, r * N + j) = SH(Msh, r * N + j) - f * SH(Msh, k * N + j);
            }
          }
        }

        // 4. gains into the out-tile: K = (-M^-1) Qux, d = (-M^-1) Qu
#pragma unroll 1
        for (int i = 0; i < N; ++i) {
          T nm[N];
#pragma unroll
          for (int s = 0; s < N; ++s) nm[s] = -SH(Msh, i * N + s);
#pragma unroll 1
          for (int j = 0; j < N; ++j) {
            T acc = nm[0] * (dt * SH(Pc, j));
#pragma unroll
            for (int s = 1; s < N; ++s)
              acc = acc + nm[s] * (dt * SH(Pc, s * N + j));
            out[i * N + j] = acc;
          }
          T acc = nm[0] * SH(Qus, 0);
#pragma unroll
          for (int s = 1; s < N; ++s) acc = acc + nm[s] * SH(Qus, s);
          out[NN + i] = acc;
        }

        // 5. K^T Quu -> Ash (the eliminated system is dead), with the
        //    unregularized Quu rebuilt from the carry
#pragma unroll 1
        for (int i = 0; i < N; ++i) {
#pragma unroll 1
          for (int j = 0; j < N; ++j) {
            T acc = T(0);
#pragma unroll
            for (int s = 0; s < N; ++s) {
              T q = dt2 * SH(Pc, s * N + j);
              if (s == j) q = (q + (Rt[s] + reg)) - reg;
              const T term = out[s * N + i] * q;
              acc = s == 0 ? term : acc + term;
            }
            SH(Ash, i * N + j) = acc;
          }
        }

        // 6. the value update into the other carry buffer
#pragma unroll 1
        for (int i = 0; i < N; ++i) {
#pragma unroll 1
          for (int j = 0; j < N; ++j) {
            T a1 = SH(Ash, i * N) * out[j];                 // K^T Quu K
            T a2 = out[i] * (dt * SH(Pc, j));               // K^T Qux
            T a3 = (dt * SH(Pc, i)) * out[j];               // Qux^T K
#pragma unroll
            for (int s = 1; s < N; ++s) {
              a1 = a1 + SH(Ash, i * N + s) * out[s * N + j];
              a2 = a2 + out[s * N + i] * (dt * SH(Pc, s * N + j));
              a3 = a3 + (dt * SH(Pc, s * N + i)) * out[s * N + j];
            }
            SH(Pn, i * N + j) =
                (((SH(Pn, i * N + j) + SH(Pc, i * N + j)) + a1) + a2) + a3;
          }
          T b1 = SH(Ash, i * N) * out[NN];                  // K^T Quu d
          T b2 = out[i] * SH(Qus, 0);                       // K^T Qu
          T b3 = (dt * SH(Pc, i)) * out[NN];                // Qux^T d
#pragma unroll
          for (int s = 1; s < N; ++s) {
            b1 = b1 + SH(Ash, i * N + s) * out[NN + s];
            b2 = b2 + out[s * N + i] * SH(Qus, s);
            b3 = b3 + (dt * SH(Pc, s * N + i)) * out[NN + s];
          }
          SH(pn, i) = ((SH(Qxs, i) + b1) + b2) + b3;
        }
      }
      T* tmp = Pc;
      Pc = Pn;
      Pn = tmp;
      tmp = pc;
      pc = pn;
      pn = tmp;
    }
    __syncwarp();

    // 7. the block's gains of this step, out of the out-tile
    if (t < H - 1) {
      const size_t orow = b0 * sHm1 + t;
      rows_out<NN>(K + orow * NN, sHm1 * NN, tout, L::kOutStride, lanes, tid);
      rows_out<N>(d + orow * N, sHm1 * N, tout + NN, L::kOutStride, lanes,
                  tid);
    }
    __syncwarp();
  }
#undef SH
}

template <int N, int NQ, typename T>
int launch(const T* J, const T* e, const T* ld, const T* lq, const T* u,
           const T* prec, const T* params, T* K, T* d, int H, int B,
           void* stream) {
  const int smem =
      static_cast<int>(Layout<N, NQ>::kVals * kThreads * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      riccati_kernel<N, NQ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_kernel<N, NQ, T><<<blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      J, e, ld, lq, u, prec, params, K, d, H, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Contiguous batch-leading arrays:
// J [B,H,nq,n], e [B,H,nq], ld/lq [B,H,n], u [B,H-1,n], prec [H,nq,nq],
// params [2+n] = (dt, reg, Rt); out K [B,H-1,n,n], d [B,H-1,n]. n = 7,
// nq = 6; H >= 2, B >= 1. Each returns the CUDA error code of the launch.
#define RICCATI_ENTRY(NAME, N, NQ, T)                                         \
  extern "C" int NAME(const T* J, const T* e, const T* ld, const T* lq,       \
                      const T* u, const T* prec, const T* params, T* K, T* d, \
                      int H, int B, void* stream) {                           \
    return launch<N, NQ, T>(J, e, ld, lq, u, prec, params, K, d, H, B,        \
                            stream);                                          \
  }

RICCATI_ENTRY(riccati_backward_f32, 7, 6, float)
RICCATI_ENTRY(riccati_backward_f64, 7, 6, double)
