// The fleet solver's keypoint cost of a whole trajectory or line-search
// trial, in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package evaluates the keypoint terms in
// plain jnp (ilqr_planner_tpu/solvers/fleet.py: _kp_terms_at), which XLA
// fuses on the TPU. Eager PyTorch runs the same math (the fleet's tensor
// path, ilqr_planner_torch/solvers/fleet.py: _kp_cost_ops over _kp_terms_at)
// as about 200 launches a keypoint step: the chain walk, the Shepperd
// quaternion, the log-map residual with its guards and e^T P e, each a few
// microseconds of work over [3, B] to [3, 3, 3, B] tensors, so the host's
// issuing of them sets the pace of a trial. Per lane, for each keypoint
// step k in order (the table's steps):
//   k < H-1:  cost += sum_j Rt_j u_j u_j for each system with a keypoint at
//             k (its own Rt), u = U[k] or Ub[k] + alpha Ud[k];
//   x = X[k] or Xb[k] + alpha Xd[k] (the affine trial, never formed);
//   the chain walk (revolute: R <- R Ro (I + sin q K + (1 - cos q) K^2),
//   prismatic: p <- p + (R Ro axis) q), the tip transform, then per system
//   its object frame (p' = Rf^T (p - pf), R' = Rf^T R) and its residual e:
//     posorn[_time]: r_p = mu_p - p, r_o = -2 E(q*) logMap(q*, quat(R)),
//       the constant dead zones, e = 0 where p and quat are all zero, and
//       for the time kind the row mu_t - x[n-1];
//     point: mu_p - p;
//   cost += sum over the systems at k of e^T P e.
// The incoming cost (the limit penalty) is read, the sum written out.
//
// What bounds it on the H100: neither side by much. Per lane it reads the
// n state rows at each keypoint step (two arrays in the affine form) and
// the m control rows at each inner one, and reads and writes the cost:
// 52 MB at posorn_h100.bulk (B = 294912, affine, steps 49 and 99), 15.5 us
// at 3.35 TB/s; 12.6 MB at timeopt_h100.bulk (B = 131072), 4 us. The
// arithmetic is 2 x 7 joints of sincos and two 3x3 products and the
// quaternion work, about 4k operations a lane: 18 us and 8 us at 67
// TFLOP/s.
//
// What this design does about it:
//  * One thread a lane, lane-major rows (B contiguous): every load of a
//    warp is one contiguous run, each state and control element is read
//    once, and nothing but the cost is written. The trial state and
//    control are formed in registers from the affine family's base and
//    direction, read where they lie (each array has its own step stride).
//  * The walk, the residual and e^T P e stay in registers; one walk a
//    keypoint step serves every system on the chain.
//  * The constants (joints, tip, frames, Rt, and per keypoint mu, P, E, the
//    unit target quaternion, the dead zones: a few hundred values, built
//    once per solver) are staged into shared memory by each block, then
//    read warp-uniformly (broadcast).
//  * Every product, sum and quotient is the plain path's, in its order and
//    rounded as it rounds (the _rn intrinsics: no contraction into FMAs),
//    with its guards as selects on the same comparisons, so NaN lanes stay
//    NaN and the kernel differs from the tensor path only where the math
//    library's sin, cos or acos differ.

#include <cuda_runtime.h>

namespace {

#define KP_THREADS 128
constexpr int kThreads = KP_THREADS;
// Residual rows at most: posorn 6, posorn_time 7, point 3.
constexpr int kMaxRows = 7;
// The table's layout (ilqr_planner_torch/ops/cuda_kernels/kp_cost.py,
// kp_table): the meta header, then prismatic flags [nj], systems [nsys][4],
// steps [nsteps][3], keypoints [nkp][8].
constexpr int kHeader = 4;  // nj, nsys, nsteps, nkp
constexpr int kJoint = 33;  // origin_pos 3, origin_rot 9, axis 3, K 9, K^2 9
constexpr int kSys = 4;     // kind (0 posorn, 1 point), time, frame, Rt
constexpr int kStep = 3;    // k, first keypoint, keypoints
constexpr int kKp = 8;      // system, nq, mu, nt, P, quat (E, unit), zone, flags
constexpr int kTargetZero = 1, kRadius = 2, kThresh = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float arccos(float a) { return acosf(a); }
__device__ __forceinline__ double arccos(double a) { return acos(a); }
__device__ __forceinline__ void sin_cos(float a, float* s, float* c) { sincosf(a, s, c); }
__device__ __forceinline__ void sin_cos(double a, double* s, double* c) { sincos(a, s, c); }

// a . v over 3 entries, summed left to right.
template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* v) {
  return add(add(mul(a[0], v[0]), mul(a[1], v[1])), mul(a[2], v[2]));
}

// A <- A B (3x3, row-major; B constant).
template <typename T>
__device__ __forceinline__ void mm_right(T* A, const T* B) {
  T C[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      C[3 * i + k] = add(add(mul(A[3 * i], B[k]), mul(A[3 * i + 1], B[3 + k])),
                         mul(A[3 * i + 2], B[6 + k]));
#pragma unroll
  for (int i = 0; i < 9; ++i) A[i] = C[i];
}

// x <- clamp(x, lo, hi), NaN kept.
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The unit quaternion (w first) of R: Shepperd's candidates, the largest
// score kept, the first on a tie and a NaN taken as the largest (argmax).
template <typename T>
__device__ __forceinline__ void mat_to_quat(const T* R, T* q) {
  const T tr = add(add(R[0], R[4]), R[8]);
  T score[4] = {tr, sub(mul(T(2), R[0]), tr), sub(mul(T(2), R[4]), tr),
                sub(mul(T(2), R[8]), tr)};
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (score[i] > score[best] || (score[i] != score[i] && score[best] == score[best]))
      best = i;
  T top = score[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (best == i) top = score[i];
  const T s = mul(T(2), root(clip(add(top, T(1)), T(1e-30), T(INFINITY))));
  // row `best` of the numerator matrix [[0, w^T], [w, R + R^T]], w the
  // skew part of R, picked by selects (no index into registers)
  const T w0 = sub(R[7], R[5]), w1 = sub(R[2], R[6]), w2 = sub(R[3], R[1]);
  const T d0 = add(R[0], R[0]), d1 = add(R[4], R[4]), d2 = add(R[8], R[8]);
  const T s01 = add(R[1], R[3]), s02 = add(R[2], R[6]), s12 = add(R[5], R[7]);
  const T row[4] = {best == 0 ? T(0) : (best == 1 ? w0 : (best == 2 ? w1 : w2)),
                    best == 0 ? w0 : (best == 1 ? d0 : (best == 2 ? s01 : s02)),
                    best == 0 ? w1 : (best == 1 ? s01 : (best == 2 ? d1 : s12)),
                    best == 0 ? w2 : (best == 1 ? s02 : (best == 2 ? s12 : d2))};
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = j == best ? mul(T(0.25), s) : quo(row[j], s);
  const T nrm =
      root(add(add(add(mul(q[0], q[0]), mul(q[1], q[1])), mul(q[2], q[2])), mul(q[3], q[3])));
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = quo(q[j], nrm);
}

template <typename T>
__device__ __forceinline__ T dot4(const T* a, const T* b) {
  return add(add(add(mul(a[0], b[0]), mul(a[1], b[1])), mul(a[2], b[2])), mul(a[3], b[3]));
}

// r_o = -2 E logMap(b, quat) with the zero guards and the hemisphere flip;
// b the unit target (b_zero: the raw target is all zero), E [3][4].
template <typename T>
__device__ __forceinline__ void orientation_residual(const T* quat, const T* b, bool b_zero,
                                                     const T* E, T* r_o) {
  const T n = root(dot4(quat, quat));
  const T nsafe = n > T(0) ? n : T(1);
  T yn[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) yn[j] = quo(quat[j], nsafe);
  const bool y_zero = quat[0] == T(0) && quat[1] == T(0) && quat[2] == T(0) && quat[3] == T(0);
  const T dot = dot4(b, yn);
  T temp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) temp[j] = sub(yn[j], mul(dot, b[j]));
  const T tn = root(dot4(temp, temp));
  const T dclip = clip(dot, T(-1), T(1));
  const T ac = arccos(dclip);
  const T dist = dclip < T(0) ? sub(ac, T(3.141592653589793)) : ac;
  const T tsafe = tn > T(0) ? tn : T(1);
  T out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[j] = tn == T(0) ? T(0) : quo(mul(dist, temp[j]), tsafe);
    if (b_zero || y_zero) out[j] = T(0);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) r_o[i] = mul(T(-2), dot4(E + 4 * i, out));
}

template <typename T>
__device__ __forceinline__ T sign_of(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : x);
}

// One lane's cost: `cost` plus the keypoint and control costs of every
// keypoint step. meta / vals: the table (shared memory).
template <typename T, bool AFFINE>
__device__ __forceinline__ T lane_cost(const int* meta, const T* vals, const T* xb,
                                       const T* xd, long long sxb, long long sxd,
                                       const T* ub, const T* ud, long long sub_,
                                       long long sud, T alpha, int n, int m, int H,
                                       long long B, long long b, T cost) {
  const int nj = meta[0], nsys = meta[1], nsteps = meta[2];
  const int* prismatic = meta + kHeader;
  const int* sys = prismatic + nj;
  const int* steps = sys + kSys * nsys;
  const int* kps = steps + kStep * nsteps;
  for (int si = 0; si < nsteps; ++si) {
    const int k = steps[kStep * si];
    const int e0 = steps[kStep * si + 1], e1 = e0 + steps[kStep * si + 2];
    if (k < H - 1) {
      for (int e = e0; e < e1; ++e) {
        const T* Rt = vals + sys[kSys * kps[kKp * e] + 3];
        T acc = T(0);
        for (int j = 0; j < m; ++j) {
          T u = ub[k * sub_ + j * B + b];
          if (AFFINE) u = add(u, mul(alpha, ud[k * sud + j * B + b]));
          acc = add(acc, mul(mul(Rt[j], u), u));
        }
        cost = add(cost, acc);
      }
    }
    // the chain walk at x_k, then the tip
    T R[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
    T p[3] = {T(0), T(0), T(0)};
    for (int i = 0; i < nj; ++i) {
      const T* c = vals + kJoint * i;
      T q = xb[k * sxb + i * B + b];
      if (AFFINE) q = add(q, mul(alpha, xd[k * sxd + i * B + b]));
#pragma unroll
      for (int r = 0; r < 3; ++r) p[r] = add(p[r], dot3(R + 3 * r, c));
      mm_right(R, c + 3);
      if (prismatic[i]) {
#pragma unroll
        for (int r = 0; r < 3; ++r) p[r] = add(p[r], mul(dot3(R + 3 * r, c + 12), q));
      } else {
        T s, co;
        sin_cos(q, &s, &co);
        const T omc = sub(T(1), co);
        T Raa[9];
#pragma unroll
        for (int j = 0; j < 9; ++j)
          Raa[j] = add(add(T(j % 4 == 0 ? 1 : 0), mul(s, c[15 + j])), mul(omc, c[24 + j]));
        mm_right(R, Raa);
      }
    }
    {
      const T* c = vals + kJoint * nj;
#pragma unroll
      for (int r = 0; r < 3; ++r) p[r] = add(p[r], dot3(R + 3 * r, c));
      mm_right(R, c + 3);
    }
    T kc = T(0);
    for (int e = e0; e < e1; ++e) {
      const int* kp = kps + kKp * e;
      const int* sy = sys + kSys * kp[0];
      const int nq = kp[1];
      const T* mu = vals + kp[2];
      T pp[3], RR[9];
      if (sy[2] >= 0) {  // the object frame: (Rf^T, pf)
        const T* RfT = vals + sy[2];
        const T d[3] = {sub(p[0], RfT[9]), sub(p[1], RfT[10]), sub(p[2], RfT[11])};
#pragma unroll
        for (int r = 0; r < 3; ++r) pp[r] = dot3(RfT + 3 * r, d);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j)
            RR[3 * i + j] = add(add(mul(RfT[3 * i], R[j]), mul(RfT[3 * i + 1], R[3 + j])),
                                mul(RfT[3 * i + 2], R[6 + j]));
      } else {
#pragma unroll
        for (int r = 0; r < 3; ++r) pp[r] = p[r];
#pragma unroll
        for (int j = 0; j < 9; ++j) RR[j] = R[j];
      }
      T ev[kMaxRows];
#pragma unroll
      for (int r = 0; r < 3; ++r) ev[r] = sub(mu[r], pp[r]);
      if (sy[0] == 0) {  // posorn, posorn_time
        const T* E = vals + kp[5];
        T quat[4];
        mat_to_quat(RR, quat);
        orientation_residual(quat, E + 12, (kp[7] & kTargetZero) != 0, E, ev + 3);
        if (kp[7] & kRadius) {
          const T radius = vals[kp[6]];
          const T nrm = root(dot3(ev, ev));
          const T safe = nrm == T(0) ? T(1) : nrm;
#pragma unroll
          for (int r = 0; r < 3; ++r)
            ev[r] = nrm <= radius ? T(0) : mul(quo(ev[r], safe), sub(nrm, radius));
        }
        if (kp[7] & kThresh) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const T th = vals[kp[6] + 1 + r];
            const T v = ev[3 + r];
            ev[3 + r] = (v < T(0) ? -v : v) <= th ? T(0) : sub(v, mul(sign_of(v), th));
          }
        }
        const bool zero_state = pp[0] == T(0) && pp[1] == T(0) && pp[2] == T(0) &&
                                quat[0] == T(0) && quat[1] == T(0) && quat[2] == T(0) &&
                                quat[3] == T(0);
        if (zero_state) {
#pragma unroll
          for (int r = 0; r < 6; ++r) ev[r] = T(0);
        }
        if (sy[1]) {  // the time row, unguarded
          const long long off = (n - 1) * B + b;
          T t = xb[k * sxb + off];
          if (AFFINE) t = add(t, mul(alpha, xd[k * sxd + off]));
          ev[6] = sub(mu[kp[3] - 1], t);
        }
      }
      // e^T P e
      const T* P = vals + kp[4];
      T c = T(0);
#pragma unroll
      for (int i = 0; i < kMaxRows; ++i) {
        if (i < nq) {
          T v = T(0);
#pragma unroll
          for (int j = 0; j < kMaxRows; ++j)
            if (j < nq) v = add(v, mul(P[nq * i + j], ev[j]));
          c = add(c, mul(ev[i], v));
        }
      }
      kc = e == e0 ? c : add(kc, c);
    }
    cost = add(cost, kc);
  }
  return cost;
}

// cost_out [B] = cost_in + the keypoint costs of lane b = blockIdx.x *
// kThreads + threadIdx.x. The block first stages the table in shared
// memory: vals [nvals] (T), then meta [nmeta] (int).
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
kp_cost_kernel(const T* __restrict__ xb, const T* __restrict__ xd, long long sxb,
               long long sxd, const T* __restrict__ ub, const T* __restrict__ ud,
               long long sub_, long long sud, T alpha, const int* __restrict__ meta_g,
               int nmeta, const T* __restrict__ vals_g, int nvals, int n, int m, int H,
               int B, const T* __restrict__ cost_in, T* __restrict__ cost_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const vals = reinterpret_cast<T*>(smem_raw);
  int* const meta = reinterpret_cast<int*>(vals + nvals);
  for (int i = threadIdx.x; i < nvals; i += kThreads) vals[i] = vals_g[i];
  for (int i = threadIdx.x; i < nmeta; i += kThreads) meta[i] = meta_g[i];
  __syncthreads();
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  cost_out[b] = lane_cost<T, AFFINE>(meta, vals, xb, xd, sxb, sxd, ub, ud, sub_, sud, alpha, n,
                                     m, H, B, b, cost_in[b]);
}

template <typename T>
int launch(const T* xb, const T* xd, long long sxb, long long sxd, const T* ub, const T* ud,
           long long sub_, long long sud, T alpha, const int* meta, int nmeta, const T* vals,
           int nvals, int n, int m, int H, int B, const T* cost_in, T* cost_out,
           void* stream) {
  const size_t smem = sizeof(T) * nvals + sizeof(int) * nmeta;
  if (B < 1 || H < 1 || n < 1 || m < 1 || nmeta < kHeader || nvals < 0 ||
      smem > 48 * 1024 || (xd == nullptr) != (ud == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads);
  const auto s = static_cast<cudaStream_t>(stream);
  if (xd != nullptr)
    kp_cost_kernel<T, true><<<grid, kThreads, smem, s>>>(xb, xd, sxb, sxd, ub, ud, sub_, sud,
                                                        alpha, meta, nmeta, vals, nvals, n, m,
                                                        H, B, cost_in, cost_out);
  else
    kp_cost_kernel<T, false><<<grid, kThreads, smem, s>>>(xb, xd, sxb, sxd, ub, ud, sub_,
                                                         sud, alpha, meta, nmeta, vals, nvals,
                                                         n, m, H, B, cost_in, cost_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. xb / xd [H, n, B] and ub / ud [H-1, m, B]
// with the lane axis contiguous and rows of one step B apart, steps sxb,
// sxd, sub, sud elements apart; xd and ud both null (the plain form: X, U)
// or both set (the affine trial xb + alpha xd, ub + alpha ud). meta [nmeta]
// (int) and vals [nvals] (T): the table (`kp_cost.kp_table`); cost_in,
// cost_out [B] contiguous (they may be one array). Each returns the CUDA
// error code of the launch.
#define KP_ENTRY(T, TAG)                                                                   \
  extern "C" int kp_cost_##TAG(const T* xb, const T* xd, long long sxb, long long sxd,     \
                               const T* ub, const T* ud, long long sub_, long long sud,    \
                               T alpha, const int* meta, int nmeta, const T* vals,         \
                               int nvals, int n, int m, int H, int B, const T* cost_in,    \
                               T* cost_out, void* stream) {                                \
    return launch<T>(xb, xd, sxb, sxd, ub, ud, sub_, sud, alpha, meta, nmeta, vals, nvals, \
                     n, m, H, B, cost_in, cost_out, stream);                               \
  }

KP_ENTRY(float, f32)
KP_ENTRY(double, f64)
