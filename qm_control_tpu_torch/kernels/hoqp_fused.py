"""K1 — the fused hierarchical-WBC QP cascade (port of
qm_control_tpu/kernels/hoqp_fused.py).

Three pieces, as for every kernel of the port:

* `cascade_plain` — the cascade in plain PyTorch on exact shapes
  (36 decision variables, nv inequality rows, the task rows of each
  level). It reproduces the arithmetic decisions of the JAX module's
  `_cascade_math` (which works on 128-lane padded buffers, a TPU tiling
  rule): diagonal-pivot Gauss-Jordan with the pivot floor, the relative
  ridge, the projector damping, the active-row mask, the Mehrotra IP with
  the dual-residual gate and best-iterate-by-merit, and the 2-step /
  1-step refinements. The CPU tests hold it against the JAX reference.
* the CUDA kernel `csrc/hoqp_fused.cu` (one thread block per cascade,
  every matrix in shared memory), built with nvcc for sm_90a on first use
  and bound with ctypes.
* the custom op `torch.ops.qm_control_tpu_torch.hoqp_fused`, on operands
  with a leading batch B: its CUDA implementation launches the kernel once
  with grid = B (one block per cascade; the blocks do not interact, so a
  launch of B equals B launches of one bit for bit), its CPU
  implementation runs `cascade_plain` per cascade. Its vmap rule folds the
  batch of `torch.func.vmap` into B, so a vmapped caller (the tick, the
  closed-loop cycle) reaches the card as one grid-B launch.
* `fused_hoqp` — the single-cascade wrapper (B = 1 through the op): CPU
  tensors run `cascade_plain`; CUDA tensors launch the kernel (and count
  the launch) or raise. `fused_hoqp_batched` takes tasks with a leading B:
  one grid-B launch on CUDA tensors, `vmap(cascade_exact)` on CPU tensors
  (the JAX package's batch cascade).

Warm layout: a (9, W) buffer, W = max(nv, 36) (56 on the WBC stack), rows
in the JAX order — 0: validity, 1: z0, 2: v0, 3: lam_a, 4: lam_b, 5: z1,
6: lam1, 7: z2, 8: lam2 — zero-padded past each row's length.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

from ..wbc.qp import _pd_inverse
from ..wbc.tasks import NUM_DECISION_VARS, Task

_EPS_H = 3e-6       # relative ridge on the level Hessian
_EPS_NULL = 1e-7    # null-space projector damping
_TAU = 0.995
_GATE_TOL = 1e-6
_MASK_LIMIT = 5e5   # rows with f >= this are structurally inactive
WARM_ROWS = 9

# launches of the CUDA kernel since the last reset, and the cascades they
# solved (a launch with grid = B adds B); the plain version on CPU tensors
# counts in neither
launch_count = 0
block_count = 0


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _refined_solve(Minv, M, rhs):
    """Minv rhs with one step of materialized iterative refinement."""
    x = Minv @ rhs
    return x + Minv @ (rhs - M @ x)


def _refined_solve_op(Minv, Mmv, rhs, steps=2):
    """M^{-1} rhs by refinement against a factor-form matvec Mmv."""
    x = Minv @ rhs
    for _ in range(steps):
        x = x + Minv @ (rhs - Mmv(x))
    return x


def _kernel_basis_qr(Az, rel_tol=1e-5):
    """Orthonormal basis of ker(Az) as an (n, n) matrix whose non-kernel
    columns are exact zeros (wbc.hoqp._kernel_basis, behind
    wbc.hoqp.USE_QR_BASIS). Column-pivoted Householder QR of B = Az'
    (n z-rows x m task-row columns): each of the m steps picks the
    remaining column of largest norm below row k (the first on ties),
    reflects it onto e_k and accumulates Q by rank-1 updates. The
    numerical rank counts the steps whose pivot norm exceeds rel_tol x
    the largest initial column norm; the basis is Q's trailing n - rank
    columns. The JAX function runs on 128-lane padded buffers with a
    one-hot pivot; this one runs on exact shapes with an argmax and
    1-element index_select (no host read, vmap-safe)."""
    n, m = Az.shape[1], Az.shape[0]
    dt, dev = Az.dtype, Az.device
    rows = torch.arange(n, device=dev)
    B = Az.T
    Q = torch.eye(n, dtype=dt, device=dev)
    unproc = torch.ones(m, dtype=torch.bool, device=dev)
    rank = torch.zeros((), dtype=dt, device=dev)
    norm0 = torch.sqrt((B * B).sum(0).max() + 1e-30)
    for k in range(m):
        rowmask = (rows >= k).to(dt)
        ek = (rows == k).to(dt)
        norms = (B * B * rowmask[:, None]).sum(0)
        j = torch.argmax(torch.where(unproc, norms, -1.0)).reshape(1)
        col_norm2 = norms.index_select(0, j)[0]
        is_rank = (torch.sqrt(col_norm2) > rel_tol * norm0).to(dt)
        v = B.index_select(1, j)[:, 0] * rowmask
        alpha = torch.sqrt(col_norm2 + 1e-30)
        sgn = torch.where((v * ek).sum() >= 0, 1.0, -1.0)
        v = v + sgn * alpha * ek
        vtv = (v * v).sum()
        beta = torch.where(vtv > 1e-30, 2.0 / vtv, 0.0) * is_rank
        B = B - v[:, None] * (beta * (v @ B))[None, :]
        Q = Q - (Q @ v)[:, None] * (beta * v)[None, :]
        unproc = unproc.index_fill(0, j, False)
        rank = rank + is_rank
    return Q * (rows.to(dt) >= rank).to(dt)[None, :]


def _tmap(f, *trees):
    return tuple(f(*xs) for xs in zip(*trees))


def _tsum(tree):
    return sum(t.sum() for t in tree)


def _ip_solve(x0, c, h, smask, m_count, Hmv, Gmv, GTmv, solveM, scale,
              qp_iters, warm=None):
    """Mehrotra predictor-corrector IP on tuple-structured primal (x) and
    slack (s) spaces, term by term as hoqp_fused.py:_ip_solve. warm:
    optional (valid, wx, wlam); valid=0 reproduces the cold start exactly.
    Returns the best (x, s, lam) by KKT merit."""
    big = 1e30
    if warm is not None:
        valid, wx, wlam = warm
        x0 = _tmap(lambda cold, w: valid * w + (1.0 - valid) * cold, x0, wx)
        s_floor = valid * 1e-3 + (1.0 - valid) * 1.0
    else:
        wlam = None
        s_floor = 1.0

    def msk(tree):
        return _tmap(lambda a, m: a * m, tree, smask)

    def merit(x, s, lam):
        r_d = _tmap(lambda a, b, cc: a + b + cc, Hmv(x), c, GTmv(lam))
        viol = msk(_tmap(lambda g, hh: torch.clamp(g - hh, min=0.0),
                         Gmv(x), h))
        return (_tsum(_tmap(lambda a: a * a, r_d))
                + 100.0 * _tsum(_tmap(lambda a: a * a, viol))
                + _tsum(msk(_tmap(lambda a, b: (a * b).abs(), s, lam))))

    def maxstep(v_tree, dv_tree):
        worst = None
        for v, dv in zip(v_tree, dv_tree):
            neg = dv < 0
            r = torch.where(neg, -v / torch.where(neg, dv, -1.0),
                            torch.full_like(v, big)).min()
            worst = r if worst is None else torch.minimum(worst, r)
        return torch.clamp(worst, max=1.0)

    s = _tmap(lambda hh, gx, m: torch.clamp(hh - gx, min=s_floor) * m
              + (1 - m), h, Gmv(x0), smask)
    lam = (smask if wlam is None else
           _tmap(lambda m, w: (valid * torch.clamp(w, min=1e-6)
                               + (1.0 - valid)) * m, smask, wlam))
    x = x0
    bx, bs, blam, bm = x, s, lam, merit(x, s, lam)
    for _ in range(qp_iters):
        s = _tmap(lambda a: torch.clamp(a, min=1e-9), s)
        lam = _tmap(lambda a: torch.clamp(a, min=1e-12), lam)
        r_d = _tmap(lambda a, b, cc: a + b + cc, Hmv(x), c, GTmv(lam))
        r_p = msk(_tmap(lambda g, ss, hh: g + ss - hh, Gmv(x), s, h))
        mu = _tsum(msk(_tmap(lambda a, b: a * b, s, lam))) / m_count
        rp_max = torch.stack([r.abs().max() for r in r_p]).max()
        # the gate also checks the DUAL residual: a warm start near the
        # previous optimum has tiny mu and r_p but carries the full
        # objective change in r_d
        rd_max = torch.stack([r.abs().max() for r in r_d]).max()
        gate = torch.where((mu < _GATE_TOL * scale)
                           & (rp_max < _GATE_TOL * scale)
                           & (rd_max < 1e-4 * scale), 0.0, 1.0)
        d = _tmap(lambda l, ss: torch.clamp(l / ss, 1e-12, 1e8), lam, s)
        # predictor (affine direction)
        rc_aff = msk(_tmap(lambda ss, l, rp: (-ss * l + l * rp) / ss,
                           s, lam, r_p))
        dx_a = solveM(d, _tmap(lambda a, b: -(a + b), r_d, GTmv(rc_aff)))
        ds_a = msk(_tmap(lambda rp, g: -rp - g, r_p, Gmv(dx_a)))
        dl_a = msk(_tmap(lambda ss, l, dsa: (-ss * l - l * dsa) / ss,
                         s, lam, ds_a))
        ap_a = maxstep(s, ds_a)
        ad_a = maxstep(lam, dl_a)
        mu_aff = _tsum(msk(_tmap(
            lambda ss, dsa, l, dla: (ss + ap_a * dsa) * (l + ad_a * dla),
            s, ds_a, lam, dl_a))) / m_count
        ratio = mu_aff / torch.clamp(mu, min=1e-12)
        sigma = torch.clamp(ratio * ratio * ratio, 1e-4, 1.0)
        # corrector
        rc = msk(_tmap(
            lambda ss, l, rp, dsa, dla:
            (sigma * mu - ss * l - dsa * dla + l * rp) / ss,
            s, lam, r_p, ds_a, dl_a))
        dx = solveM(d, _tmap(lambda a, b: -(a + b), r_d, GTmv(rc)))
        ds = msk(_tmap(lambda rp, g: -rp - g, r_p, Gmv(dx)))
        dlam = msk(_tmap(
            lambda ss, l, dsa, dla, dss:
            (sigma * mu - ss * l - dsa * dla - l * dss) / ss,
            s, lam, ds_a, dl_a, ds))
        ap = gate * _TAU * maxstep(s, ds)
        ad = gate * _TAU * maxstep(lam, dlam)
        x = _tmap(lambda a, b: a + ap * b, x, dx)
        s = _tmap(lambda a, b: a + ap * b, s, ds)
        lam = _tmap(lambda a, b: a + ad * b, lam, dlam)
        mm_ = merit(x, s, lam)
        take = mm_ < bm
        bx = _tmap(lambda n, o: torch.where(take, n, o), x, bx)
        bs = _tmap(lambda n, o: torch.where(take, n, o), s, bs)
        blam = _tmap(lambda n, o: torch.where(take, n, o), lam, blam)
        bm = torch.minimum(mm_, bm)
    return bx, bs, blam


def cascade_plain(t0: Task, t1: Task, t2: Task, qp_iters: int = 10,
                  warm=None, return_warm: bool = False):
    """The 3-level lexicographic cascade (inequalities at level 0 only) in
    plain PyTorch. Returns the (36,) decision vector, or (x, warm_out
    (9, W)) with return_warm=True; pass a previous warm_out as `warm`."""
    _check_tasks(t0, t1, t2)
    A0, b0, D, f = t0.A, t0.b, t0.D, t0.f
    nx, nv = NUM_DECISION_VARS, D.shape[0]
    dev, dt = A0.device, A0.dtype
    eye = torch.eye(nx, dtype=dt, device=dev)
    dmask = (f < _MASK_LIMIT).to(dt)
    n_act = torch.clamp(dmask.sum(), min=1.0)

    def projector(Az):
        ma = Az.shape[0]
        gram = Az @ Az.T
        lam_r = _EPS_NULL * (gram.diagonal().sum() / ma + 1.0)
        graminv = _pd_inverse(gram + lam_r * torch.eye(ma, dtype=dt,
                                                       device=dev))
        return eye - Az.T @ (graminv @ Az)

    def level_data(A, b, Z, x):
        Az = A @ Z
        gram = Az.T @ Az
        ridge = _EPS_H * (gram.diagonal().max() + 1e-3)
        Hz = gram + ridge * eye
        cz = Az.T @ (A @ x - b)

        def hz_mv(z):
            return Az.T @ (Az @ z) + ridge * z

        return Az, Hz, cz, hz_mv

    def init_solve(Hz, cz, hz_mv):
        return _refined_solve_op(_pd_inverse(Hz), hz_mv, -cz)

    if warm is not None:
        w_valid = torch.clamp(warm[0].max(), max=1.0)

    def eq_level_solve(Hz, cz, hz_mv, B, h, row_z, row_lam):
        def Gmv(z):
            return ((B @ z[0]) * dmask,)

        def GTmv(y):
            return (B.T @ y[0],)

        def solveM(d, rhs):
            S = Hz + B.T @ (d[0][:, None] * B)
            return (_refined_solve(_pd_inverse(S), S, rhs[0]),)

        scale = torch.clamp(torch.linalg.vector_norm(cz), min=1.0)
        x0 = (init_solve(Hz, cz, hz_mv),)
        lvl_warm = None if warm is None else (
            w_valid, (warm[row_z, :nx],), (warm[row_lam, :nv] * dmask,))
        bx, _, blam = _ip_solve(x0, (cz,), (h,), (dmask,), n_act,
                                lambda z: (hz_mv(z[0]),), Gmv, GTmv, solveM,
                                scale, qp_iters, warm=lvl_warm)
        return bx[0], blam[0]

    # ---------------- level 0: (z, v) with slack v ----------------
    x = torch.zeros(nx, dtype=dt, device=dev)
    Z = eye
    Az0, Hz0, cz0, hz0_mv = level_data(A0, b0, Z, x)

    def Hmv0(xz):
        z, v = xz
        return (hz0_mv(z), v)

    def Gmv0(xz):
        z, v = xz
        return (-v, D @ z - v)

    def GTmv0(y):
        y1, y2 = y
        return (D.T @ y2, -y1 - y2)

    def solveM0(d, rhs):
        d1, d2 = d
        rz, rv = rhs
        mvv = 1.0 + d1 + d2
        w = d2 * (1.0 + d1) / mvv
        S = Hz0 + D.T @ (w[:, None] * D)
        rz_s = rz + D.T @ (d2 * rv / mvv)
        dz = _refined_solve(_pd_inverse(S), S, rz_s)
        return (dz, (rv + d2 * (D @ dz)) / mvv)

    zeros_v = torch.zeros(nv, dtype=dt, device=dev)
    ones_v = torch.ones(nv, dtype=dt, device=dev)
    h0 = (zeros_v, torch.where(dmask > 0, f, torch.ones_like(f)))
    scale0 = torch.clamp(torch.linalg.vector_norm(cz0), min=1.0)
    x0_init = (init_solve(Hz0, cz0, hz0_mv), zeros_v)
    warm0 = None if warm is None else (
        w_valid, (warm[1, :nx], warm[2, :nv]),
        (warm[3, :nv], warm[4, :nv] * dmask))
    (z0s, v0s), _, (lam_as, lam_bs) = _ip_solve(
        x0_init, (cz0, zeros_v), h0, (ones_v, dmask), nv + n_act, Hmv0,
        Gmv0, GTmv0, solveM0, scale0, qp_iters, warm=warm0)
    x = x + Z @ z0s
    Z = Z @ projector(Az0)

    def carried_h(x):
        """Carried level-0 bounds f - Dx + v0*, clamped at 0 (negative
        values are f32 drift: level 0 certified feasibility)."""
        hq = f - D @ x + v0s
        return torch.where(dmask > 0, torch.clamp(hq, min=0.0),
                           torch.ones_like(hq))

    # ---------------- levels 1, 2 ----------------
    Az1, Hz1, cz1, hz1_mv = level_data(t1.A, t1.b, Z, x)
    z1s, lam1s = eq_level_solve(Hz1, cz1, hz1_mv, D @ Z, carried_h(x), 5, 6)
    x = x + Z @ z1s
    Z = Z @ projector(Az1)
    Az2, Hz2, cz2, hz2_mv = level_data(t2.A, t2.b, Z, x)
    z2s, lam2s = eq_level_solve(Hz2, cz2, hz2_mv, D @ Z, carried_h(x), 7, 8)
    x = x + Z @ z2s
    if not return_warm:
        return x
    W = warm_width(nv)
    rows = [torch.ones(W, dtype=dt, device=dev)] + [
        torch.nn.functional.pad(r, (0, W - r.shape[0]))
        for r in (z0s, v0s, lam_as, lam_bs, z1s, lam1s, z2s, lam2s)]
    return x, torch.stack(rows)


def warm_width(nv: int) -> int:
    return max(nv, NUM_DECISION_VARS)


def zero_warm(nv: int = 56, device="cuda", dtype=torch.float32):
    """A warm buffer with validity 0: the warm variant then reproduces the
    cold solve exactly."""
    from .. import resolve_device
    return torch.zeros(WARM_ROWS, warm_width(nv), dtype=dtype,
                       device=resolve_device(device))


def _check_tasks(t0: Task, t1: Task, t2: Task):
    if t1.D.shape[0] != 0 or t2.D.shape[0] != 0:
        raise ValueError("fused cascade supports inequalities at level 0 only")
    for t in (t0, t1, t2):
        if t.A.shape[1] != NUM_DECISION_VARS:
            raise ValueError(f"task width {t.A.shape[1]} != "
                             f"{NUM_DECISION_VARS}")


# ---------------------------------------------------------------------------
# CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "hoqp_fused.cu")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_ROWS, _MAX_NV = 36, 64      # the kernel's shared-memory limits
_lib = None
_lib_lock = threading.Lock()
build_info = {}                  # {"seconds", "log", "path"} of the build


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the K1 CUDA kernel is built on "
                           "the machine with the GPU")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/hoqp_fused.cu into build/libhoqp_fused_<hash>.so
    (nvcc, sm_90a); returns the library path. The hash of the source
    names the library, so an edited source is never served stale."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()
    path = os.path.join(BUILD_DIR, f"libhoqp_fused_{digest[:12]}.so")
    if os.path.exists(path) and not force:
        build_info.setdefault("seconds", 0.0)
        build_info.setdefault("log", "")
        build_info["path"] = path
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    build_info.update(seconds=time.perf_counter() - t0,
                      log=proc.stdout + proc.stderr, path=path)
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.hoqp_fused_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.hoqp_fused_smem_bytes.argtypes = []
            lib.hoqp_fused_smem_bytes.restype = ctypes.c_int
            _lib = lib
    return _lib


def smem_bytes() -> int:
    """Dynamic shared memory of one cascade block (bytes)."""
    return _load().hoqp_fused_smem_bytes()


def _operand(t, shape, dev):
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"K1 takes float32 tensors on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"K1 operand shape {tuple(t.shape)} != {shape}")
    return t.contiguous()


def _launch(A0, b0, D, f, A1, b1, A2, b2, warm, qp_iters):
    """One launch of K1 with grid = B over operands with a leading B."""
    global launch_count, block_count
    dev = A0.device
    nx = NUM_DECISION_VARS
    if A0.dim() != 3:
        raise ValueError(f"K1 takes operands with a leading batch, got A0 "
                         f"{tuple(A0.shape)}")
    B, ma0, nv, ma1, ma2 = (A0.shape[0], A0.shape[1], D.shape[1],
                            A1.shape[1], A2.shape[1])
    if not (1 <= ma0 <= _MAX_ROWS and 1 <= ma1 <= _MAX_ROWS
            and 1 <= ma2 <= _MAX_ROWS and 1 <= nv <= _MAX_NV and B >= 1):
        raise ValueError(f"K1 limits: task rows <= {_MAX_ROWS}, "
                         f"inequalities <= {_MAX_NV}, batch >= 1; got "
                         f"{ma0}/{ma1}/{ma2}, {nv}, batch {B}")
    W = warm_width(nv)
    ops = [_operand(A0, (B, ma0, nx), dev), _operand(b0, (B, ma0), dev),
           _operand(D, (B, nv, nx), dev), _operand(f, (B, nv), dev),
           _operand(A1, (B, ma1, nx), dev), _operand(b1, (B, ma1), dev),
           _operand(A2, (B, ma2, nx), dev), _operand(b2, (B, ma2), dev)]
    w_in = None if warm is None else _operand(warm, (B, WARM_ROWS, W), dev)
    x = torch.empty(B, nx, dtype=torch.float32, device=dev)
    w_out = torch.empty(B, WARM_ROWS, W, dtype=torch.float32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hoqp_fused_launch(
            *[o.data_ptr() for o in ops],
            None if w_in is None else w_in.data_ptr(),
            x.data_ptr(), w_out.data_ptr(), ma0, nv, ma1, ma2,
            int(qp_iters), B, stream)
    if err != 0:
        raise RuntimeError(f"hoqp_fused kernel launch failed: cudaError {err}")
    launch_count += 1
    block_count += B
    return x, w_out


# ---------------------------------------------------------------------------
# the custom op: K1 on a batch, and its vmap rule
# ---------------------------------------------------------------------------

@torch.library.custom_op("qm_control_tpu_torch::hoqp_fused", mutates_args=(),
                         device_types="cuda")
def hoqp_fused_op(A0: torch.Tensor, b0: torch.Tensor, D: torch.Tensor,
                  f: torch.Tensor, A1: torch.Tensor, b1: torch.Tensor,
                  A2: torch.Tensor, b2: torch.Tensor,
                  warm: Optional[torch.Tensor],
                  qp_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """B cascades, operands with a leading B (A0 (B, ma0, 36), b0 (B, ma0),
    D (B, nv, 36), f (B, nv), A1, b1, A2, b2; warm (B, 9, W) or None) ->
    (x (B, 36), warm_out (B, 9, W)). CUDA: one K1 launch, grid = B."""
    return _launch(A0, b0, D, f, A1, b1, A2, b2, warm, qp_iters)


@hoqp_fused_op.register_kernel("cpu")
def _hoqp_fused_cpu(A0, b0, D, f, A1, b1, A2, b2, warm, qp_iters):
    empty = (A1.new_zeros((0, NUM_DECISION_VARS)), A1.new_zeros(0))
    xs, ws = [], []
    for i in range(A0.shape[0]):
        x, w = cascade_plain(Task(A0[i], b0[i], D[i], f[i]),
                             Task(A1[i], b1[i], *empty),
                             Task(A2[i], b2[i], *empty), qp_iters,
                             warm=None if warm is None else warm[i],
                             return_warm=True)
        xs.append(x)
        ws.append(w)
    return torch.stack(xs), torch.stack(ws)


def _hoqp_fused_vmap(info, in_dims, *args):
    """vmap over the op: move each batched dim to the front (expand the
    unbatched operands), fold it into the op's own batch, call the op once
    (on CUDA: one launch with grid = vmap size x op batch) and unfold."""
    *operands, qp_iters = args
    n = info.batch_size

    def front(t, d):
        if t is None:
            return None
        t = t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
        return t.reshape(-1, *t.shape[2:])

    x, w = hoqp_fused_op(*[front(t, d) for t, d in zip(operands, in_dims)],
                         qp_iters)
    return ((x.reshape(n, -1, *x.shape[1:]), w.reshape(n, -1, *w.shape[1:])),
            (0, 0))


hoqp_fused_op.register_vmap(_hoqp_fused_vmap)


def _batched_operands(t0: Task, t1: Task, t2: Task):
    return (t0.A, t0.b, t0.D, t0.f, t1.A, t1.b, t2.A, t2.b)


def _device_ok(dev):
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"fused_hoqp: no kernel for device {dev}")


def fused_hoqp(t0: Task, t1: Task, t2: Task, qp_iters: int = 10,
               warm=None, return_warm: bool = False):
    """Solve the 3-level cascade; returns the (36,) decision vector, or
    (x, warm_out) with return_warm=True. CUDA tensors go through the K1
    kernel (one launch, counted in `launch_count`); CPU tensors through
    `cascade_plain`. Any other device raises. Under `torch.func.vmap` the
    op's vmap rule makes it one launch for the whole batch."""
    _check_tasks(t0, t1, t2)
    _device_ok(t0.A.device)
    x, w_out = hoqp_fused_op(
        *[a[None] for a in _batched_operands(t0, t1, t2)],
        None if warm is None else warm[None], int(qp_iters))
    return (x[0], w_out[0]) if return_warm else x[0]


def fused_hoqp_batched(t0: Task, t1: Task, t2: Task, qp_iters: int = 10,
                       warm=None, return_warm: bool = False):
    """Batched cascade: tasks carry a leading batch dim B; returns (B, 36)
    decision vectors, or (x, warm_out (B, 9, W)). CUDA tensors: one K1
    launch with grid = B. CPU tensors: `vmap(cascade_exact)`, the JAX
    package's batch path (qm_control_tpu/kernels/hoqp_fused.py:655-686)."""
    for t in (t1, t2):
        if t.D.shape[-2] != 0:
            raise ValueError("fused cascade supports inequalities at level "
                             "0 only")
    dev = t0.A.device
    _device_ok(dev)
    if dev.type == "cuda":
        x, w_out = hoqp_fused_op(*_batched_operands(t0, t1, t2), warm,
                                 int(qp_iters))
        return (x, w_out) if return_warm else x
    from torch.func import vmap

    from .cascade_exact import cascade_exact, warm_from_buffer, warm_to_buffer
    nv = t0.D.shape[-2]

    def one(a, b, c, w):
        return cascade_exact(a, b, c, qp_iters, warm=w, return_warm=True)

    if warm is None:
        x, w_ex = vmap(lambda a, b, c: one(a, b, c, None))(t0, t1, t2)
    else:
        x, w_ex = vmap(one)(t0, t1, t2, warm_from_buffer(warm, nv))
    return (x, warm_to_buffer(w_ex)) if return_warm else x
