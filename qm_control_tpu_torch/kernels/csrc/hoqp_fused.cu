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
// moves ~20 KB; the cascade needs ~10 MFLOP of f32 and K1 does ~34 (it
// rebuilds the Schur matrix and its inverse for the corrector, and each
// Gauss-Jordan step updates the whole augmented buffer), as ~63 dependent
// 36-step Gauss-Jordan eliminations (3 levels x (1 + 2 x qp_iters) +
// projectors) inside one block: the time is the serial chain of
// ~thousands of block barriers. The design keeps every matrix resident in shared memory at
// exact shape (dynamic shared memory, ~96 KB), ping-pongs the GJ augmented
// buffer so each elimination step costs one barrier, and reduces with warp
// shuffles. Redesigning it for latency (warp-per-row GJ, fewer barriers,
// a CUDA graph around the tick) is later work.
//
// Interface: plain C, loaded with ctypes. Launches on the given stream,
// allocates nothing, returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NX = 36;          // decision variables [v_dot(24); F(12)]
constexpr int MAX_ROWS = 36;    // task rows per level (projector gram <= NX)
constexpr int MAX_NV = 64;      // inequality rows of level 0
constexpr int NP = NX + MAX_NV; // IP primal length (level 0: [z; v])
constexpr int NS = 2 * MAX_NV;  // IP slack length (level 0: two row groups)
constexpr int NT = 256;         // threads per block
constexpr int AUGW = 2 * NX;    // max augmented-row width

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
  float aug[2][NX * AUGW];    // Gauss-Jordan [M | I] (ping-pong)
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
  float gt[NS], ht[NP], t1[NP], t2[NP], t3[NX];
  float red[4];
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

// Block-wide reduction of f(i), i < n: warp 0 reduces with shuffles, every
// thread gets the result.
template <int OP, class F>
__device__ __forceinline__ float reduce(int n, F f, float* red) {
  float acc = OP == R_SUM ? 0.f : (OP == R_MAX ? -INFINITY : INFINITY);
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < n; i += 32) acc = comb<OP>(acc, f(i));
    for (int o = 16; o > 0; o >>= 1)
      acc = comb<OP>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (threadIdx.x == 0) red[0] = acc;
  }
  __syncthreads();
  acc = red[0];
  __syncthreads();
  return acc;
}

// ---------------------------------------------------------------------------
// dense algebra on shared memory (row stride NX unless noted)
// ---------------------------------------------------------------------------

// Gauss-Jordan inverse of the leading n x n block of M; returns the
// augmented buffer whose columns n..2n-1 (row stride 2n) hold M^{-1}.
__device__ const float* gj_inverse(Shared& s, const float* M, int n) {
  const int w = 2 * n;
  float* cur = s.aug[0];
  float* nxt = s.aug[1];
  for (int idx = threadIdx.x; idx < n * w; idx += NT) {
    int i = idx / w, j = idx - i * w;
    cur[idx] = j < n ? M[i * NX + j] : (j - n == i ? 1.f : 0.f);
  }
  float dsum = reduce<R_SUM>(n, [&](int i) { return fabsf(M[i * NX + i]); },
                           s.red);
  const float floor_ = 1e-10f * (dsum / n + 1.f);
  unsigned long long elim = 0ull;
  const int lane = threadIdx.x & 31;
  for (int step = 0; step < n; ++step) {
    // pivot: every warp computes the same arg-max of the remaining
    // diagonal (ties -> smallest index)
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = lane; i < n; i += 32) {
      float cv = ((elim >> i) & 1ull) ? NEG : cur[i * w + i];
      if (cv > bv) { bv = cv; bi = i; }
    }
    for (int o = 16; o > 0; o >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    const int p = bi;
    float piv = cur[p * w + p];
    if (fabsf(piv) < floor_) piv = piv < 0.f ? -floor_ : floor_;
    for (int idx = threadIdx.x; idx < n * w; idx += NT) {
      int i = idx / w, j = idx - i * w;
      float rj = cur[p * w + j] / piv;
      nxt[idx] = (i == p) ? rj : cur[idx] - cur[i * w + p] * rj;
    }
    elim |= 1ull << p;
    __syncthreads();
    float* t = cur; cur = nxt; nxt = t;
  }
  return cur;
}

// y = Minv x with Minv inside an augmented buffer of order n
__device__ void inv_mv(const float* aug, int n, const float* x, float* y) {
  const int w = 2 * n;
  for (int i = threadIdx.x; i < n; i += NT) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc += aug[i * w + n + j] * x[j];
    y[i] = acc;
  }
  __syncthreads();
}

// out = Az' (Az z) + ridge z  (factor-form level Hessian; uses s.r)
__device__ void hz_mv(Shared& s, const Level& L, const float* z, float* out) {
  for (int i = threadIdx.x; i < L.ma; i += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += s.Az[i * NX + k] * z[k];
    s.r[i] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int i = 0; i < L.ma; ++i) acc += s.Az[i * NX + j] * s.r[i];
    out[j] = acc + L.ridge * z[j];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the IP's linear operators (hoqp_fused.py Hmv0/Gmv0/GTmv0/solveM0 and
// eq_level_solve's Hmv/Gmv/GTmv/solveM)
// ---------------------------------------------------------------------------

__device__ void op_H(Shared& s, const Level& L, int nv, const float* x,
                     float* out) {
  if (L.lvl0)
    for (int i = threadIdx.x; i < nv; i += NT) out[NX + i] = x[NX + i];
  hz_mv(s, L, x, out);
}

__device__ void op_G(Shared& s, const Level& L, int nv, const float* x,
                     float* out) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  for (int i = threadIdx.x; i < nv; i += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += Dm[i * NX + k] * x[k];
    if (L.lvl0) {
      out[i] = -x[NX + i];
      out[nv + i] = acc - x[NX + i];
    } else {
      out[i] = acc * s.dmask[i];
    }
  }
  __syncthreads();
}

__device__ void op_GT(Shared& s, const Level& L, int nv, const float* y,
                      float* out) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  const float* y2 = L.lvl0 ? y + nv : y;
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int i = 0; i < nv; ++i) acc += Dm[i * NX + j] * y2[i];
    out[j] = acc;
  }
  if (L.lvl0)
    for (int i = threadIdx.x; i < nv; i += NT) out[NX + i] = -y[i] - y[nv + i];
  __syncthreads();
}

// dx = (H + G' diag(d) G)^{-1} rhs; level 0 by Schur elimination of the
// diagonal slack block. Uses s.S, s.aug, s.gt, s.t1, s.t2, s.t3.
__device__ void op_solve(Shared& s, const Level& L, int nv, const float* d,
                         const float* rhs, float* dx) {
  const float* Dm = L.lvl0 ? s.D : s.B;
  float* w = s.gt;          // per-row weights
  float* tv = s.gt + nv;    // level 0: d2 rv / mvv
  if (L.lvl0) {
    for (int i = threadIdx.x; i < nv; i += NT) {
      float d1 = d[i], d2 = d[nv + i];
      float mvv = 1.f + d1 + d2;
      w[i] = d2 * (1.f + d1) / mvv;
      tv[i] = d2 * rhs[NX + i] / mvv;
    }
  } else {
    for (int i = threadIdx.x; i < nv; i += NT) w[i] = d[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < NX * NX; idx += NT) {
    int j = idx / NX, k = idx - j * NX;
    float acc = 0.f;
    for (int i = 0; i < nv; ++i)
      acc += Dm[i * NX + j] * (w[i] * Dm[i * NX + k]);
    s.S[idx] = s.Hz[idx] + acc;
  }
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
  const float* inv = gj_inverse(s, s.S, NX);
  // one step of materialized refinement
  inv_mv(inv, NX, rz, dx);
  float* res = s.t2;
  for (int j = threadIdx.x; j < NX; j += NT) {
    float acc = 0.f;
    for (int k = 0; k < NX; ++k) acc += s.S[j * NX + k] * dx[k];
    res[j] = rz[j] - acc;
  }
  __syncthreads();
  inv_mv(inv, NX, res, s.t3);
  for (int j = threadIdx.x; j < NX; j += NT) dx[j] += s.t3[j];
  __syncthreads();
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

// KKT merit: |r_d|^2 + 100 |viol|^2 + sum m |s lam|. Uses s.ht, s.t1, s.gt.
__device__ float merit(Shared& s, const Level& L, int nv, const float* x,
                       const float* sl, const float* lam) {
  op_H(s, L, nv, x, s.ht);
  op_GT(s, L, nv, lam, s.t1);
  float a = reduce<R_SUM>(L.np, [&](int i) {
    float r = s.ht[i] + s.c[i] + s.t1[i];
    return r * r;
  }, s.red);
  op_G(s, L, nv, x, s.gt);
  float b = reduce<R_SUM>(L.ns, [&](int i) {
    float v = fmaxf(s.gt[i] - s.h[i], 0.f) * s.smask[i];
    return v * v;
  }, s.red);
  float cc = reduce<R_SUM>(L.ns, [&](int i) {
    return fabsf(sl[i] * lam[i]) * s.smask[i];
  }, s.red);
  return a + 100.f * b + cc;
}

__device__ float maxstep(Shared& s, int n, const float* v, const float* dv) {
  float worst = reduce<R_MIN>(n, [&](int i) {
    return dv[i] < 0.f ? -v[i] / dv[i] : BIG;
  }, s.red);
  return fminf(1.f, worst);
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
  op_G(s, L, nv, s.px, s.gt);
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

  for (int it = 0; it < iters; ++it) {
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      s.ps[i] = fmaxf(s.ps[i], 1e-9f);
      s.pl[i] = fmaxf(s.pl[i], 1e-12f);
    }
    __syncthreads();
    op_H(s, L, nv, s.px, s.ht);
    op_GT(s, L, nv, s.pl, s.t1);
    for (int i = threadIdx.x; i < L.np; i += NT)
      s.rd[i] = s.ht[i] + s.c[i] + s.t1[i];
    __syncthreads();
    op_G(s, L, nv, s.px, s.gt);
    for (int i = threadIdx.x; i < L.ns; i += NT)
      s.rp[i] = (s.gt[i] + s.ps[i] - s.h[i]) * s.smask[i];
    __syncthreads();
    const float mu = reduce<R_SUM>(L.ns, [&](int i) {
      return s.ps[i] * s.pl[i] * s.smask[i];
    }, s.red) / m_count;
    const float rp_max = reduce<R_MAX>(L.ns, [&](int i) {
      return fabsf(s.rp[i]);
    }, s.red);
    const float rd_max = reduce<R_MAX>(L.np, [&](int i) {
      return fabsf(s.rd[i]);
    }, s.red);
    // the gate also checks the DUAL residual (a warm start near the
    // previous optimum has tiny mu and r_p but the full objective change
    // in r_d)
    const float gate = (mu < GATE_TOL * scale && rp_max < GATE_TOL * scale &&
                        rd_max < 1e-4f * scale) ? 0.f : 1.f;
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      float sl = s.ps[i], l = s.pl[i], m = s.smask[i];
      s.dd[i] = fminf(fmaxf(l / sl, 1e-12f), 1e8f);
      s.rc[i] = (-sl * l + l * s.rp[i]) / sl * m;     // affine
    }
    __syncthreads();
    // predictor
    op_GT(s, L, nv, s.rc, s.t1);
    for (int i = threadIdx.x; i < L.np; i += NT)
      s.rhs[i] = -(s.rd[i] + s.t1[i]);
    __syncthreads();
    op_solve(s, L, nv, s.dd, s.rhs, s.dxa);
    op_G(s, L, nv, s.dxa, s.gt);
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      float m = s.smask[i], sl = s.ps[i], l = s.pl[i];
      float dsa = (-s.rp[i] - s.gt[i]) * m;
      s.dsa[i] = dsa;
      s.dla[i] = (-sl * l - l * dsa) / sl * m;
    }
    __syncthreads();
    const float ap_a = maxstep(s, L.ns, s.ps, s.dsa);
    const float ad_a = maxstep(s, L.ns, s.pl, s.dla);
    const float mu_aff = reduce<R_SUM>(L.ns, [&](int i) {
      return (s.ps[i] + ap_a * s.dsa[i]) * (s.pl[i] + ad_a * s.dla[i]) *
             s.smask[i];
    }, s.red) / m_count;
    const float ratio = mu_aff / fmaxf(mu, 1e-12f);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 1.f);
    // corrector
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      float sl = s.ps[i], l = s.pl[i];
      s.rc[i] = (sigma * mu - sl * l - s.dsa[i] * s.dla[i] + l * s.rp[i]) /
                sl * s.smask[i];
    }
    __syncthreads();
    op_GT(s, L, nv, s.rc, s.t1);
    for (int i = threadIdx.x; i < L.np; i += NT)
      s.rhs[i] = -(s.rd[i] + s.t1[i]);
    __syncthreads();
    op_solve(s, L, nv, s.dd, s.rhs, s.dx);
    op_G(s, L, nv, s.dx, s.gt);
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      float m = s.smask[i], sl = s.ps[i], l = s.pl[i];
      float ds = (-s.rp[i] - s.gt[i]) * m;
      s.ds[i] = ds;
      s.dl[i] = (sigma * mu - sl * l - s.dsa[i] * s.dla[i] - l * ds) / sl * m;
    }
    __syncthreads();
    const float ap = gate * TAU * maxstep(s, L.ns, s.ps, s.ds);
    const float ad = gate * TAU * maxstep(s, L.ns, s.pl, s.dl);
    for (int i = threadIdx.x; i < L.np; i += NT) s.px[i] += ap * s.dx[i];
    for (int i = threadIdx.x; i < L.ns; i += NT) {
      s.ps[i] += ap * s.ds[i];
      s.pl[i] += ad * s.dl[i];
    }
    __syncthreads();
    const float mm = merit(s, L, nv, s.px, s.ps, s.pl);
    if (mm < bm) {     // identical decision in every thread
      for (int i = threadIdx.x; i < L.np; i += NT) s.bx[i] = s.px[i];
      for (int i = threadIdx.x; i < L.ns; i += NT) {
        s.bs[i] = s.ps[i];
        s.bl[i] = s.pl[i];
      }
    }
    bm = fminf(mm, bm);
    __syncthreads();
  }
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
  const int w = 2 * ma;
  float* U = s.Hz;                       // free after the level's IP
  for (int idx = threadIdx.x; idx < ma * NX; idx += NT) {
    int i = idx / NX, k = idx - i * NX;
    float acc = 0.f;
    for (int j = 0; j < ma; ++j) acc += inv[i * w + ma + j] * s.Az[j * NX + k];
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

__global__ void __launch_bounds__(NT)
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
  static bool configured = false;
  const int smem = (int)sizeof(Shared);
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        hoqp_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  hoqp_fused_kernel<<<batch, NT, smem, (cudaStream_t)stream>>>(
      A0, b0, D, f, A1, b1, A2, b2, warm_in, x_out, warm_out, ma0, nv, ma1,
      ma2, qp_iters);
  return (int)cudaGetLastError();
}

}  // extern "C"
