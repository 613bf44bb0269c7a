"""K1's work: the operations and bytes one WBC cascade needs.

`k1_work` is a frozen copy of chip_smoke.py:412-453 (`_k1_work`, commit
174fa4e), unchanged. It counts the work from the cascade's shapes (the
rows of each level, the inequality rows, the fixed IP iteration count),
not from what a kernel does, so a rewritten K1 is measured against the
same work.
"""
import json
import os


def k1_work(ma0, nv, ma1, ma2, iters, nx=36):
    """(flops, bytes) that one cascade needs, from the shapes and the fixed
    iteration count (every IP iteration is computed: the gate zeroes the
    step, it skips no work). Counted as the function needs them, not as K1
    does them: a product of (m, k) and (k, n) is 2 m k n; a Gauss-Jordan
    inverse of order n is 2 n^3 (the identity half is never multiplied);
    one Schur matrix S and one inverse per IP iteration (the predictor and
    the corrector share the same d); level 0's basis Z is the identity, so
    its A Z, D Z and Z z cost nothing."""
    def mv(m, n):
        return 2 * m * n

    def gj(n):
        return 2 * n ** 3

    flops = 0
    for lvl, ma in enumerate((ma0, ma1, ma2)):
        if lvl:
            flops += 2 * ma * nx * nx + 2 * nv * nx * nx     # A Z, B = D Z
            flops += mv(nv, nx)                              # carried D x
        flops += 2 * ma * nx * nx                            # Hz = Az' Az
        flops += 2 * mv(ma, nx)                              # cz
        # init solve: Hz^-1, then 2 factor-form refinement steps; the IP's
        # starting slack (G x) and merit
        flops += gj(nx) + 3 * mv(nx, nx) + 2 * 2 * mv(ma, nx)
        flops += 2 * mv(ma, nx) + 3 * mv(nv, nx)
        # one IP iteration: S = Hz + G' diag(w) G and its inverse; two
        # Newton solves of 3 matvecs each (materialized refinement); the
        # Hessian matvec twice (r_d, merit); the inequality matvecs (G or
        # G' with G = D or B: r_d, r_p, 2 per Newton solve, merit 2, and at
        # level 0 the slack block's 2 per solve)
        g_mvs = 12 if lvl == 0 else 8
        flops += iters * (2 * nv * nx * nx + gj(nx) + 2 * 3 * mv(nx, nx)
                          + 2 * 2 * mv(ma, nx) + g_mvs * mv(nv, nx))
        flops += mv(nx, nx) if lvl else 0                    # x += Z z
        if lvl < 2:                                          # projector
            flops += (2 * ma * ma * nx + gj(ma) + 2 * ma * ma * nx
                      + 2 * nx * nx * ma)
            flops += 2 * nx ** 3 if lvl else 0               # Z P
    w = max(nv, nx)
    n_in = (ma0 + ma1 + ma2) * (nx + 1) + nv * (nx + 1)
    return flops, 4 * (n_in + nx + 9 * w)


def peaks(kind="H100"):
    """The published peaks of one card (counts/peaks.json)."""
    with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as fh:
        return json.load(fh)[kind]


def k1_bound_s(stack, kind="H100"):
    """Least seconds one cascade of `stack` ({"ma0", "nv", "ma1", "ma2",
    "qp_iters"}) takes on the card: the larger of its operations over the
    f32 peak and its bytes over the memory bandwidth."""
    flops, nbytes = k1_work(stack["ma0"], stack["nv"], stack["ma1"],
                            stack["ma2"], stack["qp_iters"])
    p = peaks(kind)
    return max(flops / p["f32_flop_per_s"], nbytes / p["hbm_byte_per_s"])
