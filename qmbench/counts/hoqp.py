"""The pivoted cascade's work: the operations and bytes one cascade of the
port's `wbc/hoqp.py` over `wbc/qp.py` needs (upstream's HoQp.cpp:12-158
with a fixed-iteration interior point in place of qpOASES).

Counted from the cascade's shapes (the rows of each level, the
inequality rows, the fixed IP iteration count) as the function needs
them, not from what the code launches, so that a kernel written for the
cascade is measured against the same work. The conventions of k1.py: a
product of (m, k) and (k, n) is 2 m k n; a Gauss-Jordan inverse of order
n is 2 n^3 (the identity half is never multiplied); every IP iteration
is computed (the gate zeroes the step, it skips no work); level 0's
basis Z is the identity and its x is 0, so its A Z, D Z, D x and Z z
cost nothing; the last level's null-space update is never used.
Element-wise work is not counted. Where k1.py eliminates the slacks by a
Schur complement, the pivoted cascade solves each level's full KKT
system: level 0 has nx + nv unknowns (the decision variables and one
slack per inequality) under 2 nv rows (v >= 0 and D z - v <= f), each
lower level nx unknowns under the nv carried rows.
"""
from .k1 import peaks


def mv(m, n):
    return 2 * m * n


def gj(n):
    return 2 * n ** 3


def lu_solve(n, rhs=1):
    """A factorized solve of order n with `rhs` right-hand sides: the LU
    (2/3 n^3) and two triangular solves per right-hand side."""
    return 2 * n ** 3 // 3 + 2 * n * n * rhs


def qp_work(n, m, ma, iters, nx=36):
    """One level's interior point (qp.solve_qp) with n unknowns and m
    inequality rows, whose Hessian's factor form is ma task rows over the
    nx decision variables: the start (a solve of H, the slack G x, the
    merit) and `iters` iterations, each: the dual residual (the factor-
    form H and G' lam), the primal residual (G x), the Newton matrix H +
    G' diag(d) G and its inverse, the predictor's and the corrector's
    solves (three products with the inverse and two with the matrix, the
    refinement, then G' rc and G dx), the merit (the factor-form H, G'
    lam, G x)."""
    h_mv = 2 * mv(ma, nx)
    start = lu_solve(n) + mv(m, n) + h_mv + 2 * mv(m, n)
    newton = 5 * mv(n, n) + 2 * mv(m, n)
    it = (h_mv + 2 * mv(m, n) + 2 * m * n * n + gj(n) + 2 * newton
          + h_mv + 2 * mv(m, n))
    return start + iters * it


def level_work(lvl, ma, nv, iters, last, nx=36):
    """Operations of level `lvl` (0 is the top) with ma task rows and nv
    inequality rows (level 0's own, carried by the levels below)."""
    flops = 2 * ma * nx * nx + mv(ma, nx)           # Hz = Az' Az, Az' r
    if lvl:
        flops += 2 * ma * nx * nx + mv(ma, nx)       # Az = A Z, r = A x - b
        flops += 2 * nv * nx * nx + mv(nv, nx)       # carried D Z, D x
        flops += qp_work(nx, nv, ma, iters, nx)
        flops += mv(nx, nx)                          # x += Z z
    else:
        flops += qp_work(nx + nv, 2 * nv, ma, iters, nx)
    if not last:                                     # damped projector
        flops += 2 * ma * ma * nx + lu_solve(ma, nx) + 2 * nx * nx * ma
        flops += 2 * nx ** 3 if lvl else 0           # Z P
    return flops


def hoqp_work(ma0, nv, ma1, ma2, iters, nx=36):
    """(flops, bytes) that one cascade needs: the levels' operations, and
    the float32 levels read (A, b of each; D, f of level 0) with x
    written."""
    rows = (ma0, ma1, ma2)
    flops = sum(level_work(lvl, ma, nv, iters, lvl == len(rows) - 1, nx)
                for lvl, ma in enumerate(rows))
    n_in = sum(rows) * (nx + 1) + nv * (nx + 1)
    return flops, 4 * (n_in + nx)


def hoqp_bound_s(stack, kind="H100"):
    """Least seconds one cascade of `stack` ({"ma0", "nv", "ma1", "ma2",
    "qp_iters"}) takes on the card: the larger of its operations over the
    f32 peak (67 TFLOP/s on the H100, which is also its FP64 tensor-core
    peak; the interior points run in float64) and its bytes over the
    memory bandwidth."""
    flops, nbytes = hoqp_work(stack["ma0"], stack["nv"], stack["ma1"],
                              stack["ma2"], stack["qp_iters"])
    p = peaks(kind)
    return max(flops / p["f32_flop_per_s"], nbytes / p["hbm_byte_per_s"])
