// K1 — the fused 3-level hierarchical-WBC QP cascade, one thread block per
// cascade, written by hand for Hopper (sm_90a).
//
// Replaces: qm_control_tpu/kernels/hoqp_fused.py:_fused_call (the Pallas
// TPU kernel, bodies `kernel` (cold) and `kernel_w` (warm), math in
// `_cascade_math`). The same arithmetic decisions are reproduced on exact
// shapes (36 decision variables, nv inequality rows, task rows ma0/ma1/ma2)
// instead of the TPU's 128-lane padded buffers:
//   * Gauss-Jordan inverse with diagonal pivoting: largest remaining
//     diagonal, ties toward the smallest index; pivot floor
//     1e-10 * (sum|diag| / n + 1);
//   * relative ridge EPS_H * (max diag + 1e-3) on each level Hessian,
//     projector damping EPS_NULL * (tr / ma + 1);
//   * active-row mask f < 5e5 and n_act; Mehrotra predictor-corrector IP
//     for qp_iters iterations with the dual-residual gate, the sigma clamp,
//     TAU and the best iterate by KKT merit;
//   * factor-form refinement (2 steps) in the init solve, materialized
//     refinement (1 step) in the IP Newton solves; level-0 slack block
//     Schur-eliminated so every solve is 36-dimensional.
//
// What bounds it on this card: neither bytes nor FLOPs. Per cascade it
// moves ~20 KB and needs ~10 MFLOP of f32 (0.16 us at the H100's peak);
// it takes ~0.93-0.96 ms on an H100 (700 W) at the WBC stack's shapes.
// The time is a serial chain inside one block: 35 dependent Gauss-Jordan
// eliminations of ~36 steps (3 levels x (1 + qp_iters) + 2 projectors),
// one barrier each, about 60 % of it, and ~30 barrier-separated vector
// phases per IP iteration. The design is for that latency:
//   * one block of 256 threads per cascade, every matrix resident in
//     dynamic shared memory at exact shape (~78 KB);
//   * one factorization per IP iteration: S = H + G' diag(w) G and its
//     inverse depend on d only, so the predictor and the corrector share
//     them (op_factor, then op_solve twice);
//   * the Gauss-Jordan works in place on an n x n ping-pong buffer (the
//     inverse's column p replaces the eliminated column p); each thread
//     owns a column and six rows, so the step has no index arithmetic and
//     one division per thread, and the last warp computes the next pivot
//     while the others update, so a step is one barrier and no search;
//   * reductions that read the same data back to back run in one pass and
//     one barrier pair; independent matvecs run side by side on disjoint
//     thread ranges; the merit's H x and G x serve the next iteration's
//     residuals; right-hand sides and step directions are formed in the
//     phase of their matvec.
// Every value keeps its arithmetic (the same operations in the same order,
// products that were rounded stay rounded, each sum's lane assignment and
// shuffle order), so the output is bit for bit that of the straightforward
// design with an augmented [M | I] elimination, two eliminations per IP
// iteration and one reduction per pass (held equal on 34 test cascades on
// an H100).
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int NX = 36;          // decision variables [v_dot(24); F(12)]
constexpr int MAX_ROWS = 36;    // task rows per level (projector gram <= NX)
constexpr int MAX_NV = 64;      // inequality rows of level 0
constexpr int NP = NX + MAX_NV; // IP primal length (level 0: [z; v])
constexpr int NS = 2 * MAX_NV;  // IP slack length (level 0: two row groups)
constexpr int NT = 256;         // threads per block
constexpr int NG = 6;           // row groups of a (column, row group) map:
                                // NX * NG = 216 threads, six rows each; the
                                // last warp stays free (the pivot scout)
static_assert(NX % NG == 0 && NX * NG <= NT - 32, "row-group map");

constexpr float EPS_H = 3e-6f;
constexpr float EPS_NULL = 1e-7f;
constexpr float TAU = 0.995f;
constexpr float GATE_TOL = 1e-6f;
constexpr float BIG = 1e30f;
constexpr float NEG = -3e38f;
constexpr float MASK_LIMIT = 5e5f;

struct __align__(16) Shared {
  float D[MAX_NV * NX];
  float f[MAX_NV];
  float dmask[MAX_NV];
  float A[MAX_ROWS * NX];     // current level's task matrix
  float b[MAX_ROWS];
  float Z[2][NX * NX];        // null-space basis (ping-pong)
  float Az[MAX_ROWS * NX];
  float Hz[NX * NX];
  float S[NX * NX];
  float P[NX * NX];
  float B[MAX_NV * NX];       // D Z (levels 1, 2)
  float gj[2][NX * NX];       // in-place Gauss-Jordan (ping-pong)
  float x[NX];                // accumulated decision vector
  float cz[NX];
  float r[MAX_ROWS];          // scratch (task-row space)
  float v0s[MAX_NV];          // level-0 slack-variable solution
  // interior-point state
  float c[NP], h[NS], smask[NS];
  float px[NP], ps[NS], pl[NS];
  float bx[NP], bs[NS], bl[NS];
  float rd[NP], rp[NS], dd[NS];
  float rc[NS], rhs[NP];
  float dxa[NP], dsa[NS], dla[NS];
  float dx[NP], ds[NS], dl[NS];
  float gt[NS], ht[NP], t1[NP], t2[NP];
  float red[4];
  int piv[2];                 // the next Gauss-Jordan pivot (ping-pong)
  float pivv[2];              // ... and its diagonal entry
};

struct Level {
  bool lvl0;     // level 0: primal [z; v], slack [-v <= 0 ; Dz - v <= f]
  int np, ns;    // primal / slack lengths
  int ma;        // task rows of this level
  float ridge;   // Hessian ridge
};

enum { R_SUM = 0, R_MAX = 1, R_MIN = 2 };

template <int OP>
__device__ __forceinline__ float comb(float a, float b) {
  return OP == R_SUM ? a + b : (OP == R_MAX ? fmaxf(a, b) : fminf(a, b));
}

template <int OP>
__device__ __forceinline__ float ident() {
  return OP == R_SUM ? 0.f : (OP == R_MAX ? -INFINITY : INFINITY);
}

// K (1 to 3) block-wide reductions of f_k(i), i < n_k, in one pass and one
// barrier pair: warp 0 reduces with shuffles (lane l folds i = l, l + 32,
// ... in order, then xor-shuffles 16, 8, 4, 2, 1), every thread gets the
// results in out.
template <int K, int O0, int O1, int O2, class F0, class F1, class F2>
__device__ __forceinline__ void reduce_k(int n0, F0 f0, int n1, F1 f1, int n2,
                                         F2 f2, float* red, float* out) {
  float a0 = ident<O0>(), a1 = ident<O1>(), a2 = ident<O2>();
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < n0; i += 32) a0 = comb<O0>(a0, f0(i));
    if (K > 1)
      for (int i = threadIdx.x; i < n1; i += 32) a1 = comb<O1>(a1, f1(i));
    if (K > 2)
      for (int i = threadIdx.x; i < n2; i += 32) a2 = comb<O2>(a2, f2(i));
    for (int o = 16; o > 0; o >>= 1) {
      a0 = comb<O0>(a0, __shfl_xor_sync(0xffffffffu, a0, o));
      if (K > 1) a1 = comb<O1>(a1, __shfl_xor_sync(0xffffffffu, a1, o));
      if (K > 2) a2 = comb<O2>(a2, __shfl_xor_sync(0xffffffffu, a2, o));
    }
    if (threadIdx.x == 0) {
      red[0] = a0;
      if (K > 1) red[1] = a1;
      if (K > 2) red[2] = a2;
    }
  }
  __syncthreads();
  out[0] = red[0];
  if (K > 1) out[1] = red[1];
  if (K > 2) out[2] = red[2];
  __syncthreads();
}

template <int OP, class F>
__device__ __forceinline__ float reduce(int n, F f, float* red) {
  float out[1];
  reduce_k<1, OP, OP, OP>(n, f, 0, f, 0, f, red, out);
  return out[0];
}

// ---------------------------------------------------------------------------
// dense algebra on shared memory (row stride NX unless noted)
// ---------------------------------------------------------------------------

// Order-preserving key of a pivot candidate: larger float, larger key;
// -0 and +0 share a key (they compare equal); NaN gets 0, below every
// float, as it never wins a comparison.
__device__ __forceinline__ unsigned pivot_key(float v) {
  if (v != v) return 0u;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Arg-max of the pivot keys k0 (index lane) and k1 (index lane + 32)
// across the warp, ties to the smallest index.
__device__ __forceinline__ int warp_argmax(unsigned k0, unsigned k1) {
  const unsigned kmax = __reduce_max_sync(0xffffffffu, k0 > k1 ? k0 : k1);
  const unsigned b0 = __ballot_sync(0xffffffffu, k0 == kmax);
  const unsigned b1 = __ballot_sync(0xffffffffu, k1 == kmax);
  return b0 ? __ffs(b0) - 1 : 31 + __ffs(b1);
}

// Gauss-Jordan inverse of the leading n x n block of M (row stride NX),
// done in place on an n x n buffer (row stride n, ping-ponged so a step
// costs one barrier): the inverse's column p is stored where the
// eliminated column p was. Threads tid < NX * NG own column
// j = tid % NX and rows g, g + NG, ... (g = tid / NX) and divide their
// pivot-row entry once per step. The arithmetic is that of the augmented
// [M | I] elimination: entry (i, j != p) becomes
// cur[i,j] - cur[i,p] * (cur[p,j] / piv), the pivot column
// 0 - cur[i,p] * (1 / piv) (the identity half's zero minus the same
// product), the pivot entry 1 / piv. The pivot is the largest remaining
// diagonal, ties to the smallest index. The last warp finds the next
// step's pivot while the others update: it forms the diagonal this step
// writes (the owners' expression, so the same bits) and publishes its
// arg-max and that entry in s.piv, s.pivv, so a step starts with its
// pivot known.
__device__ const float* gj_inverse(Shared& s, const float* M, int n) {
  float* cur = s.gj[0];
  float* nxt = s.gj[1];
  const int j = threadIdx.x % NX;
  const int g = threadIdx.x / NX;
  const bool mine = g < NG && j < n;
  const bool scout = threadIdx.x >= NT - 32;
  if (mine)
    for (int i = g; i < n; i += NG) cur[i * n + j] = M[i * NX + j];
  float dsum = reduce<R_SUM>(n, [&](int i) { return fabsf(M[i * NX + i]); },
                           s.red);
  const float floor_ = 1e-10f * (dsum / n + 1.f);
  const int lane = threadIdx.x & 31;
  const int i1 = lane + 32;
  unsigned long long elim = 0ull;
  int p = warp_argmax(lane < n ? pivot_key(cur[lane * n + lane]) : 0u,
                      i1 < n ? pivot_key(cur[i1 * n + i1]) : 0u);
  float piv = cur[p * n + p];
  for (int step = 0; step < n; ++step) {
    if (step) {
      p = s.piv[step & 1];
      piv = s.pivv[step & 1];
    }
    if (fabsf(piv) < floor_) piv = piv < 0.f ? -floor_ : floor_;
    if (mine) {
      constexpr int R = NX / NG;
      // 1 / piv for the pivot column (correctly rounded either way)
      const float rj = (j == p ? 1.f : cur[p * n + j]) / piv;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = g + r * NG;
        if (i < n) {
          const float c = j == p ? 0.f : cur[i * n + j];
          nxt[i * n + j] = (i == p) ? rj : c - cur[i * n + p] * rj;
        }
      }
    } else if (scout && step + 1 < n) {
      elim |= 1ull << p;
      unsigned k0 = 0u, k1 = 0u;
      float v0 = NEG, v1 = NEG;
      if (lane < n) {
        if (!((elim >> lane) & 1ull)) {
          const float r = cur[p * n + lane] / piv;
          v0 = cur[lane * n + lane] - cur[lane * n + p] * r;
        }
        k0 = pivot_key(v0);
      }
      if (i1 < n) {
        if (!((elim >> i1) & 1ull)) {
          const float r = cur[p * n + i1] / piv;
          v1 = cur[i1 * n + i1] - cur[i1 * n + p] * r;
        }
        k1 = pivot_key(v1);
      }
      const int pn = warp_argmax(k0, k1);
      const float vn = __shfl_sync(0xffffffffu, pn < 32 ? v0 : v1, pn & 31);
      if (lane == 0) {
        s.piv[(step + 1) & 1] = pn;
        s.pivv[(step + 1) & 1] = vn;
      }
    }
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  return cur;
}

// y = Minv x (add: y += Minv x), Minv of order n (row stride n)
__device__ void inv_mv(const float* inv, int n, const float* x, float* y,
                       bool add = false) {
  for (int i = threadIdx.x; i < n; i += NT) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += inv[i * n + j] * x[j];
    y[i] = add ? y[i] + acc : acc;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the IP's linear operators (hoqp_fused.py Hmv0/Gmv0/GTmv0/solveM0 and
// eq_level_solve's Hmv/Gmv/GTmv/solveM), one output element per call so
// that a phase can compute several of them between two barriers
// ---------------------------------------------------------------------------

// (Az z)_i
__device__ __forceinline__ float az_row(const Shared& s, const float* z,
                                        int i) {
  float acc = 0.f;
  for (int k = 0; k < NX; ++k) acc += s.Az[i * NX + k] * z[k];
  return acc;
}

// (Az' r + ridge z)_j with r = s.r = Az z: the level Hessian in factor form
__device__ __forceinline__ float azt_col(const Shared& s, const Level& L,
                                         const float* z, int j) {
  float acc = 0.f;
  for (int i = 0; i < L.ma; ++i) acc += s.Az[i * NX + j] * s.r[i];
  return acc + L.ridge * z[j];
}

// rows of G x for row i < nv: level 0 writes out[i] = -v_i and
// out[nv + i] = D_i z - v_i, the other levels out[i] = m_i B_i z
__device__ __forceinline__ void g_row(const Shared& s, const Level& L, int nv,
                                      const float* x, float* out, int i) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  float acc = 0.f;
  for (int k = 0; k < NX; ++k) acc += Dm[i * NX + k] * x[k];
  if (L.lvl0) {
    out[i] = -x[NX + i];
    out[nv + i] = acc - x[NX + i];
  } else {
    out[i] = __fmul_rn(acc, s.dmask[i]);   // rounded: never fused into a sum
  }
}

// (G' y)_j for j < NX (level 0's slack entries: -y_i - y_{nv+i})
__device__ __forceinline__ float gt_col(const Shared& s, const Level& L,
                                        int nv, const float* y, int j) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  const float* y2 = L.lvl0 ? y + nv : y;
  float acc = 0.f;
  for (int i = 0; i < nv; ++i) acc += Dm[i * NX + j] * y2[i];
  return acc;
}

// out = Az' (Az z) + ridge z  (uses s.r)
__device__ void hz_mv(Shared& s, const Level& L, const float* z, float* out) {
  for (int i = threadIdx.x; i < L.ma; i += NT) s.r[i] = az_row(s, z, i);
  __syncthreads();
  for (int j = threadIdx.x; j < NX; j += NT) out[j] = azt_col(s, L, z, j);
  __syncthreads();
}

// H x -> s.ht and G x -> s.gt, plus G' lam -> s.t1, in two phases: the
// products are independent, so disjoint thread ranges compute them side
// by side (ma, nv <= 64, NX = 36).
__device__ void hgx_gtl(Shared& s, const Level& L, int nv, const float* x,
                        const float* lam) {
  const int t = threadIdx.x;
  if (t < L.ma) s.r[t] = az_row(s, x, t);
  if (t >= 64 && t < 64 + NX) s.t1[t - 64] = gt_col(s, L, nv, lam, t - 64);
  if (L.lvl0 && t >= 128 && t < 128 + nv) {
    s.t1[NX + t - 128] = -lam[t - 128] - lam[nv + t - 128];
    s.ht[NX + t - 128] = x[NX + t - 128];
  }
  if (t >= 192 && t < 192 + nv) g_row(s, L, nv, x, s.gt, t - 192);
  __syncthreads();
  if (t < NX) s.ht[t] = azt_col(s, L, x, t);
  __syncthreads();
}

// The factor of the IP's Newton matrix: S = H + G' diag(w) G (level 0:
// the Schur complement of the diagonal slack block, weights w in s.gt;
// the other levels w = d) and its inverse. Depends on d only, so the
// predictor and the corrector of one IP iteration share it. Writes s.S
// and s.gj, which keep them for op_solve. Returns S^{-1}.
__device__ const float* op_factor(Shared& s, const Level& L, int nv,
                                  const float* d) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  const float* w = L.lvl0 ? s.gt : d;
  // S[j, k] = Hz[j, k] + sum_i D[i, j] (w_i D[i, k]), each entry one chain
  // over i in order; a thread owns column k and rows g, g + NG, ... so it
  // forms w_i D[i, k] once for all its rows
  const int k = threadIdx.x % NX;
  const int g = threadIdx.x / NX;
  if (g < NG) {
    constexpr int R = NX / NG;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < nv; ++i) {
      const float wd = w[i] * Dm[i * NX + k];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += Dm[i * NX + g + r * NG] * wd;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      s.S[(g + r * NG) * NX + k] = s.Hz[(g + r * NG) * NX + k] + acc[r];
  }
  __syncthreads();
  return gj_inverse(s, s.S, NX);
}

// The Newton right-hand side rhs = -(r_d + G' rc); level 0 also forms
// the Schur term d2 rv / mvv (in s.gt + nv) for op_solve.
__device__ void newton_rhs(Shared& s, const Level& L, int nv, const float* d) {
  const int t = threadIdx.x;
  if (t < NX) s.rhs[t] = -(s.rd[t] + gt_col(s, L, nv, s.rc, t));
  if (L.lvl0 && t >= 64 && t < 64 + nv) {
    const int i = t - 64;
    const float rv = -(s.rd[NX + i] + (-s.rc[i] - s.rc[nv + i]));
    s.rhs[NX + i] = rv;
    float d1 = d[i], d2 = d[nv + i];
    float mvv = 1.f + d1 + d2;
    s.gt[nv + i] = d2 * rv / mvv;
  }
  __syncthreads();
}

// dx = S^{-1} rhs with S, inv from op_factor and one step of materialized
// refinement; level 0 back-substitutes the slack block. Leaves s.S and
// s.gj as they are; uses s.t1, s.t2.
__device__ void op_solve(Shared& s, const Level& L, int nv, const float* d,
                         const float* inv, float* dx) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  const float* rhs = s.rhs;
  const float* tv = s.gt + nv;
  float* rz = s.t1;         // Schur-reduced right-hand side
  for (int j = threadIdx.x; j < NX; j += NT) {
    if (L.lvl0) {
      float acc = 0.f;
      for (int i = 0; i < nv; ++i) acc += Dm[i * NX + j] * tv[i];
      rz[j] = rhs[j] + acc;
    } else {
      rz[j] = rhs[j];
    }
  }
  __syncthreads();
  inv_mv(inv, NX, rz, dx);
  float* res = s.t2;
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += s.S[j * NX + k] * dx[k];
    res[j] = rz[j] - acc;
  }
  __syncthreads();
  inv_mv(inv, NX, res, dx, true);
  if (L.lvl0) {
    for (int i = threadIdx.x; i < nv; i += NT) {
      float acc = 0.f;
      for (int k = 0; k < NX; ++k) acc += Dm[i * NX + k] * dx[k];
      float d1 = d[i], d2 = d[nv + i];
      float mvv = 1.f + d1 + d2;
      dx[NX + i] = (rhs[NX + i] + d2 * acc) / mvv;
    }
    __syncthreads();
  }
}

// KKT merit: |r_d|^2 + 100 |viol|^2 + sum m |s lam|. Leaves H x in s.ht
// and G x in s.gt (the next IP iteration's residuals reuse them); uses
// s.t1, s.r.
__device__ float merit(Shared& s, const Level& L, int nv, const float* x,
                       const float* sl, const float* lam) {
  hgx_gtl(s, L, nv, x, lam);
  float sums[3];
  reduce_k<3, R_SUM, R_SUM, R_SUM>(L.np, [&](int i) {
    float r = s.ht[i] + s.c[i] + s.t1[i];
    return r * r;
  }, L.ns, [&](int i) {
    float v = fmaxf(s.gt[i] - s.h[i], 0.f) * s.smask[i];
    return v * v;
  }, L.ns, [&](int i) {
    return fabsf(sl[i] * lam[i]) * s.smask[i];
  }, s.red, sums);
  return sums[0] + 100.f * sums[1] + sums[2];
}

// The primal and dual step lengths min(1, min_{dv < 0} -v / dv), in one
// pass.
__device__ void maxsteps(Shared& s, int n, const float* v0, const float* dv0,
                         const float* v1, const float* dv1, float& a0,
                         float& a1) {
  float w[2];
  reduce_k<2, R_MIN, R_MIN, R_MIN>(n, [&](int i) {
    return dv0[i] < 0.f ? -v0[i] / dv0[i] : BIG;
  }, n, [&](int i) {
    return dv1[i] < 0.f ? -v1[i] / dv1[i] : BIG;
  }, 0, [&](int) { return 0.f; }, s.red, w);
  a0 = fminf(1.f, w[0]);
  a1 = fminf(1.f, w[1]);
}

// Mehrotra predictor-corrector IP (hoqp_fused.py:_ip_solve). On entry
// s.px holds the cold initial primal, s.c/s.h/s.smask the problem; warm
// (if has_warm) holds the blended start: wx (np) and wlam (ns) already
// masked. Returns with the best iterate in s.bx, s.bs, s.bl.
__device__ void ip_solve(Shared& s, const Level& L, int nv, float m_count,
                         float scale, int iters, bool has_warm, float valid,
                         const float* wx, const float* wlam) {
  float s_floor = 1.f;
  if (has_warm) {
    for (int i = threadIdx.x; i < L.np; i += NT)
      s.px[i] = valid * wx[i] + (1.f - valid) * s.px[i];
    s_floor = valid * 1e-3f + (1.f - valid) * 1.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nv; i += NT) g_row(s, L, nv, s.px, s.gt, i);
  __syncthreads();
  for (int i = threadIdx.x; i < L.ns; i += NT) {
    float m = s.smask[i];
    s.ps[i] = fmaxf(s.h[i] - s.gt[i], s_floor) * m + (1.f - m);
    s.pl[i] = has_warm ? (valid * fmaxf(wlam[i], 1e-6f) + (1.f - valid)) * m
                       : m;
  }
  for (int i = threadIdx.x; i < L.np; i += NT) s.bx[i] = s.px[i];
  __syncthreads();
  for (int i = threadIdx.x; i < L.ns; i += NT) {
    s.bs[i] = s.ps[i];
    s.bl[i] = s.pl[i];
  }
  __syncthreads();
  float bm = merit(s, L, nv, s.px, s.ps, s.pl);

  const int t = threadIdx.x;
  for (int it = 0; it < iters; ++it) {
    // (the best-iterate copy at the end of the previous iteration used
    // the same index map, so no barrier sits between it and this clamp)
    for (int i = t; i < L.ns; i += NT) {
      s.ps[i] = fmaxf(s.ps[i], 1e-9f);
      s.pl[i] = fmaxf(s.pl[i], 1e-12f);
    }
    __syncthreads();
    // r_d = H x + c + G' lam, r_p = m (G x + s - h); H x and G x of this x
    // are still in s.ht and s.gt from the last merit
    if (t < NX) s.rd[t] = s.ht[t] + s.c[t] + gt_col(s, L, nv, s.pl, t);
    if (L.lvl0 && t >= 64 && t < 64 + nv)
      s.rd[NX + t - 64] = s.ht[NX + t - 64] + s.c[NX + t - 64] +
                          (-s.pl[t - 64] - s.pl[nv + t - 64]);
    if (t >= 128 && t < 128 + L.ns)
      s.rp[t - 128] = (s.gt[t - 128] + s.ps[t - 128] - s.h[t - 128]) *
                      s.smask[t - 128];
    __syncthreads();
    float red3[3];
    reduce_k<3, R_SUM, R_MAX, R_MAX>(L.ns, [&](int i) {
      return s.ps[i] * s.pl[i] * s.smask[i];
    }, L.ns, [&](int i) {
      return fabsf(s.rp[i]);
    }, L.np, [&](int i) {
      return fabsf(s.rd[i]);
    }, s.red, red3);
    const float mu = red3[0] / m_count;
    const float rp_max = red3[1], rd_max = red3[2];
    // the gate also checks the DUAL residual (a warm start near the
    // previous optimum has tiny mu and r_p but the full objective change
    // in r_d)
    const float gate = (mu < GATE_TOL * scale && rp_max < GATE_TOL * scale &&
                        rd_max < 1e-4f * scale) ? 0.f : 1.f;
    // d, the affine rc, and level 0's Schur weights (rows i and nv + i of
    // one thread)
    for (int i = t; i < nv; i += NT) {
      for (int q = 0; q < (L.lvl0 ? 2 : 1); ++q) {
        const int k = i + q * nv;
        float sl = s.ps[k], l = s.pl[k], m = s.smask[k];
        s.dd[k] = fminf(fmaxf(l / sl, 1e-12f), 1e8f);
        s.rc[k] = (-sl * l + l * s.rp[k]) / sl * m;     // affine
      }
      if (L.lvl0) {
        float d1 = s.dd[i], d2 = s.dd[nv + i];
        float mvv = 1.f + d1 + d2;
        s.gt[i] = d2 * (1.f + d1) / mvv;
      }
    }
    __syncthreads();
    // one factorization for both Newton solves
    const float* inv = op_factor(s, L, nv, s.dd);
    // predictor
    newton_rhs(s, L, nv, s.dd);
    op_solve(s, L, nv, s.dd, inv, s.dxa);
    for (int i = t; i < nv; i += NT) {
      g_row(s, L, nv, s.dxa, s.gt, i);
      for (int q = 0; q < (L.lvl0 ? 2 : 1); ++q) {
        const int k = i + q * nv;
        float m = s.smask[k], sl = s.ps[k], l = s.pl[k];
        float dsa = (-s.rp[k] - s.gt[k]) * m;
        s.dsa[k] = dsa;
        s.dla[k] = (-sl * l - l * dsa) / sl * m;
      }
    }
    __syncthreads();
    float ap_a, ad_a;
    maxsteps(s, L.ns, s.ps, s.dsa, s.pl, s.dla, ap_a, ad_a);
    const float mu_aff = reduce<R_SUM>(L.ns, [&](int i) {
      return (s.ps[i] + ap_a * s.dsa[i]) * (s.pl[i] + ad_a * s.dla[i]) *
             s.smask[i];
    }, s.red) / m_count;
    const float ratio = mu_aff / fmaxf(mu, 1e-12f);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 1.f);
    // corrector
    for (int i = t; i < L.ns; i += NT) {
      float sl = s.ps[i], l = s.pl[i];
      s.rc[i] = (sigma * mu - sl * l - s.dsa[i] * s.dla[i] + l * s.rp[i]) /
                sl * s.smask[i];
    }
    __syncthreads();
    newton_rhs(s, L, nv, s.dd);
    op_solve(s, L, nv, s.dd, inv, s.dx);
    for (int i = t; i < nv; i += NT) {
      g_row(s, L, nv, s.dx, s.gt, i);
      for (int q = 0; q < (L.lvl0 ? 2 : 1); ++q) {
        const int k = i + q * nv;
        float m = s.smask[k], sl = s.ps[k], l = s.pl[k];
        float ds = (-s.rp[k] - s.gt[k]) * m;
        s.ds[k] = ds;
        s.dl[k] = (sigma * mu - sl * l - s.dsa[k] * s.dla[k] - l * ds) / sl * m;
      }
    }
    __syncthreads();
    float ap, ad;
    maxsteps(s, L.ns, s.ps, s.ds, s.pl, s.dl, ap, ad);
    ap = gate * TAU * ap;
    ad = gate * TAU * ad;
    for (int i = t; i < L.np; i += NT) s.px[i] += ap * s.dx[i];
    for (int i = t; i < L.ns; i += NT) {
      s.ps[i] += ap * s.ds[i];
      s.pl[i] += ad * s.dl[i];
    }
    __syncthreads();
    const float mm = merit(s, L, nv, s.px, s.ps, s.pl);
    if (mm < bm) {     // identical decision in every thread
      for (int i = t; i < L.np; i += NT) s.bx[i] = s.px[i];
      for (int i = t; i < L.ns; i += NT) {
        s.bs[i] = s.ps[i];
        s.bl[i] = s.pl[i];
      }
    }
    bm = fminf(mm, bm);
  }
  __syncthreads();
}

// Az = A Z, Hz = Az'Az + ridge I, cz = Az'(A x - b); returns the ridge.
__device__ float level_data(Shared& s, const float* Zc, int ma) {
  for (int idx = threadIdx.x; idx < ma * NX; idx += NT) {
    int i = idx / NX, k = idx - i * NX;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += s.A[i * NX + j] * Zc[j * NX + k];
    s.Az[idx] = acc;
  }
  for (int i = threadIdx.x; i < ma; i += NT) {
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += s.A[i * NX + j] * s.x[j];
    s.r[i] = acc - s.b[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NX * NX; idx += NT) {
    int j = idx / NX, k = idx - j * NX;
    float acc = 0.f;
    for (int i = 0; i < ma; ++i) acc += s.Az[i * NX + j] * s.Az[i * NX + k];
    s.Hz[idx] = acc;
  }
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int i = 0; i < ma; ++i) acc += s.Az[i * NX + j] * s.r[i];
    s.cz[j] = acc;
  }
  __syncthreads();
  const float dmax = reduce<R_MAX>(NX, [&](int i) { return s.Hz[i * NX + i]; },
                                 s.red);
  const float ridge = EPS_H * (dmax + 1e-3f);
  for (int j = threadIdx.x; j < NX; j += NT) s.Hz[j * NX + j] += ridge;
  __syncthreads();
  return ridge;
}

// px[0:NX] = Hz^{-1}(-cz) with two factor-form refinement steps.
__device__ void init_solve(Shared& s, const Level& L) {
  const float* inv = gj_inverse(s, s.Hz, NX);
  for (int j = threadIdx.x; j < NX; j += NT) s.t2[j] = -s.cz[j];
  __syncthreads();
  inv_mv(inv, NX, s.t2, s.px);
  for (int step = 0; step < 2; ++step) {
    hz_mv(s, L, s.px, s.ht);
    for (int j = threadIdx.x; j < NX; j += NT) s.t2[j] = -s.cz[j] - s.ht[j];
    __syncthreads();
    inv_mv(inv, NX, s.t2, s.dx);
    for (int j = threadIdx.x; j < NX; j += NT) s.px[j] += s.dx[j];
    __syncthreads();
  }
}

// Znew = Z (I - Az' (Az Az' + lam_r I)^{-1} Az); returns the new Z buffer.
__device__ int project(Shared& s, int zi, int ma) {
  for (int idx = threadIdx.x; idx < ma * ma; idx += NT) {
    int i = idx / ma, k = idx - i * ma;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += s.Az[i * NX + j] * s.Az[k * NX + j];
    s.S[i * NX + k] = acc;
  }
  __syncthreads();
  const float tr = reduce<R_SUM>(ma, [&](int i) { return s.S[i * NX + i]; },
                               s.red);
  const float lam_r = EPS_NULL * (tr / ma + 1.f);
  for (int i = threadIdx.x; i < ma; i += NT) s.S[i * NX + i] += lam_r;
  __syncthreads();
  const float* inv = gj_inverse(s, s.S, ma);
  float* U = s.Hz;                       // free after the level's IP
  for (int idx = threadIdx.x; idx < ma * NX; idx += NT) {
    int i = idx / NX, k = idx - i * NX;
    float acc = 0.f;
    for (int j = 0; j < ma; ++j) acc += inv[i * ma + j] * s.Az[j * NX + k];
    U[idx] = acc;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NX * NX; idx += NT) {
    int j = idx / NX, k = idx - j * NX;
    float acc = 0.f;
    for (int i = 0; i < ma; ++i) acc += s.Az[i * NX + j] * U[i * NX + k];
    s.P[idx] = (j == k ? 1.f : 0.f) - acc;
  }
  __syncthreads();
  const float* Zc = s.Z[zi];
  float* Zn = s.Z[1 - zi];
  for (int idx = threadIdx.x; idx < NX * NX; idx += NT) {
    int j = idx / NX, k = idx - j * NX;
    float acc = 0.f;
    for (int l = 0; l < NX; ++l) acc += Zc[j * NX + l] * s.P[l * NX + k];
    Zn[idx] = acc;
  }
  __syncthreads();
  return 1 - zi;
}

// x += Z z (z = s.bx[0:NX])
__device__ void accumulate_x(Shared& s, int zi) {
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += s.Z[zi][j * NX + k] * s.bx[k];
    s.t2[j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NX; j += NT) s.x[j] += s.t2[j];
  __syncthreads();
}

__device__ void load(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// Equality level (1 or 2): task (A, b) in the damped null space Z, with
// the level-0 rows carried down: B = D Z, h = max(f - D x + v0*, 0).
__device__ int eq_level(Shared& s, int zi, const float* Ag, const float* bg,
                        int ma, int nv, float n_act, int iters,
                        const float* warm, int ww, int wz_row, int wl_row,
                        float w_valid, float* wout) {
  load(s.A, Ag, ma * NX);
  load(s.b, bg, ma);
  __syncthreads();
  Level L{false, NX, nv, ma, 0.f};
  L.ridge = level_data(s, s.Z[zi], ma);
  const float* Zc = s.Z[zi];
  for (int idx = threadIdx.x; idx < nv * NX; idx += NT) {
    int i = idx / NX, k = idx - i * NX;
    float acc = 0.f;
    for (int j = 0; j < NX; ++j) acc += s.D[i * NX + j] * Zc[j * NX + k];
    s.B[idx] = acc;
  }
  for (int i = threadIdx.x; i < nv; i += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += s.D[i * NX + k] * s.x[k];
    float hq = s.f[i] - acc + s.v0s[i];
    s.h[i] = s.dmask[i] > 0.f ? fmaxf(hq, 0.f) : 1.f;
    s.smask[i] = s.dmask[i];
  }
  for (int j = threadIdx.x; j < NX; j += NT) s.c[j] = s.cz[j];
  __syncthreads();
  const float scale = fmaxf(1.f, sqrtf(reduce<R_SUM>(NX, [&](int j) {
    return s.cz[j] * s.cz[j];
  }, s.red)));
  init_solve(s, L);
  if (warm) {
    // warm primal/dual, masked as in the JAX warm contract
    for (int j = threadIdx.x; j < NX; j += NT) s.t1[j] = warm[wz_row * ww + j];
    for (int i = threadIdx.x; i < nv; i += NT)
      s.rc[i] = warm[wl_row * ww + i] * s.dmask[i];
    __syncthreads();
  }
  ip_solve(s, L, nv, n_act, scale, iters, warm != nullptr, w_valid, s.t1,
           s.rc);
  for (int j = threadIdx.x; j < ww; j += NT) {
    wout[wz_row * ww + j] = j < NX ? s.bx[j] : 0.f;
    wout[wl_row * ww + j] = j < nv ? s.bl[j] : 0.f;
  }
  accumulate_x(s, zi);
  return zi;
}

__global__ void __launch_bounds__(NT, 1)
hoqp_fused_kernel(const float* __restrict__ A0, const float* __restrict__ b0,
                  const float* __restrict__ Dg, const float* __restrict__ fg,
                  const float* __restrict__ A1, const float* __restrict__ b1,
                  const float* __restrict__ A2, const float* __restrict__ b2,
                  const float* __restrict__ warm_in, float* __restrict__ x_out,
                  float* __restrict__ warm_out, int ma0, int nv, int ma1,
                  int ma2, int iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& s = *reinterpret_cast<Shared*>(smem_raw);
  const int ww = nv > NX ? nv : NX;      // warm row width
  const int bid = blockIdx.x;
  A0 += (size_t)bid * ma0 * NX; b0 += (size_t)bid * ma0;
  Dg += (size_t)bid * nv * NX;  fg += (size_t)bid * nv;
  A1 += (size_t)bid * ma1 * NX; b1 += (size_t)bid * ma1;
  A2 += (size_t)bid * ma2 * NX; b2 += (size_t)bid * ma2;
  x_out += (size_t)bid * NX;
  warm_out += (size_t)bid * 9 * ww;
  const float* warm = warm_in ? warm_in + (size_t)bid * 9 * ww : nullptr;

  // ---- inputs (read once), masks, Z = I, x = 0 ----
  load(s.D, Dg, nv * NX);
  load(s.f, fg, nv);
  load(s.A, A0, ma0 * NX);
  load(s.b, b0, ma0);
  for (int i = threadIdx.x; i < nv; i += NT)
    s.dmask[i] = fg[i] < MASK_LIMIT ? 1.f : 0.f;
  for (int idx = threadIdx.x; idx < NX * NX; idx += NT)
    s.Z[0][idx] = (idx / NX == idx % NX) ? 1.f : 0.f;
  for (int j = threadIdx.x; j < NX; j += NT) s.x[j] = 0.f;
  __syncthreads();
  const float n_act = fmaxf(reduce<R_SUM>(nv, [&](int i) { return s.dmask[i]; },
                                        s.red), 1.f);
  float w_valid = 0.f;
  if (warm) w_valid = fminf(reduce<R_MAX>(ww, [&](int j) { return warm[j]; },
                                        s.red), 1.f);

  // ---- level 0: (z, v) with slack v ----
  int zi = 0;
  Level L0{true, NX + nv, 2 * nv, ma0, 0.f};
  L0.ridge = level_data(s, s.Z[0], ma0);
  for (int i = threadIdx.x; i < nv; i += NT) {
    s.c[NX + i] = 0.f;
    s.h[i] = 0.f;
    s.h[nv + i] = s.dmask[i] > 0.f ? s.f[i] : 1.f;
    s.smask[i] = 1.f;
    s.smask[nv + i] = s.dmask[i];
  }
  for (int j = threadIdx.x; j < NX; j += NT) s.c[j] = s.cz[j];
  __syncthreads();
  const float scale0 = fmaxf(1.f, sqrtf(reduce<R_SUM>(NX, [&](int j) {
    return s.cz[j] * s.cz[j];
  }, s.red)));
  init_solve(s, L0);
  for (int i = threadIdx.x; i < nv; i += NT) s.px[NX + i] = 0.f;
  if (warm) {
    for (int j = threadIdx.x; j < NX; j += NT) s.t1[j] = warm[1 * ww + j];
    for (int i = threadIdx.x; i < nv; i += NT) {
      s.t1[NX + i] = warm[2 * ww + i];
      s.rc[i] = warm[3 * ww + i];
      s.rc[nv + i] = warm[4 * ww + i] * s.dmask[i];
    }
  }
  __syncthreads();
  ip_solve(s, L0, nv, (float)nv + n_act, scale0, iters, warm != nullptr,
           w_valid, s.t1, s.rc);
  for (int i = threadIdx.x; i < nv; i += NT) s.v0s[i] = s.bx[NX + i];
  for (int j = threadIdx.x; j < ww; j += NT) {
    warm_out[0 * ww + j] = 1.f;
    warm_out[1 * ww + j] = j < NX ? s.bx[j] : 0.f;
    warm_out[2 * ww + j] = j < nv ? s.bx[NX + j] : 0.f;
    warm_out[3 * ww + j] = j < nv ? s.bl[j] : 0.f;
    warm_out[4 * ww + j] = j < nv ? s.bl[nv + j] : 0.f;
  }
  accumulate_x(s, zi);
  zi = project(s, zi, ma0);

  // ---- levels 1 and 2 ----
  eq_level(s, zi, A1, b1, ma1, nv, n_act, iters, warm, ww, 5, 6, w_valid,
           warm_out);
  zi = project(s, zi, ma1);
  eq_level(s, zi, A2, b2, ma2, nv, n_act, iters, warm, ww, 7, 8, w_valid,
           warm_out);
  for (int j = threadIdx.x; j < NX; j += NT) x_out[j] = s.x[j];
}

}  // namespace

extern "C" {

// Shared memory one cascade block needs (bytes).
int hoqp_fused_smem_bytes() { return (int)sizeof(Shared); }

// Launch `batch` cascades (grid = batch, one block each) on `stream`.
// Arrays are contiguous f32 with a leading batch dim: A0 (ma0,36), b0
// (ma0), D (nv,36), f (nv), A1 (ma1,36), b1, A2 (ma2,36), b2; warm_in
// (9, max(nv,36)) or NULL for the cold variant; outputs x_out (36) and
// warm_out (9, max(nv,36)). Returns a cudaError_t.
int hoqp_fused_launch(const float* A0, const float* b0, const float* D,
                      const float* f, const float* A1, const float* b1,
                      const float* A2, const float* b2, const float* warm_in,
                      float* x_out, float* warm_out, int ma0, int nv,
                      int ma1, int ma2, int qp_iters, int batch,
                      void* stream) {
  if (ma0 < 1 || ma0 > MAX_ROWS || ma1 < 1 || ma1 > MAX_ROWS || ma2 < 1 ||
      ma2 > MAX_ROWS || nv < 1 || nv > MAX_NV || qp_iters < 0 || batch < 1)
    return (int)cudaErrorInvalidValue;
  // The shared-memory attribute belongs to the current device (the
  // caller's device guard makes it the operands' card): set it once per
  // device, on that device's first launch. One bit per device index.
  static std::atomic<unsigned long long> configured{0};
  const int smem = (int)sizeof(Shared);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const unsigned long long bit = 1ull << dev;
  if (!(configured.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(
        hoqp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured.fetch_or(bit, std::memory_order_release);
  }
  hoqp_fused_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      A0, b0, D, f, A1, b1, A2, b2, warm_in, x_out, warm_out, ma0, nv, ma1,
      ma2, qp_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
