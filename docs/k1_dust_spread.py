"""How far 1e-7 relative input dust moves the WBC cascade, on one GPU:

    python3 docs/k1_dust_spread.py

For the stance and trot stacks of chip_smoke.py phase 3, 256 copies each
with 1e-7 relative dust (numpy seed 11): K1 (one launch with grid = 256)
and vmap(cascade_plain) on the card. Prints, per stack, percentiles of
how far the dust moves each implementation's torques from its undusted
solution and how far the two land apart; phase 3's residual criterion
counted in both directions; the per-level ratio of the two residuals;
and the distance of each to the plain cascade in float64 (the undusted
stack, and the first 16 dusted scenarios). chip_smoke.py phase 3b's
bounds rest on these numbers (PERF.md).
"""
import os
import sys

import numpy as np
import torch
from torch.func import vmap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
from qm_control_tpu_torch.kernels import hoqp_fused as K  # noqa: E402
from qm_control_tpu_torch.models import centroidal as C  # noqa: E402
from qm_control_tpu_torch.models import load_model  # noqa: E402
from qm_control_tpu_torch.wbc import tasks as T  # noqa: E402

N = 256


def _pct(v, qs=(50, 90, 99, 100)):
    return np.round(np.percentile(v.cpu().numpy(), qs), 4)


def main():
    if not torch.cuda.is_available():
        print("k1_dust_spread: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(S._smi())
    model = load_model()
    info = C.make_centroidal_info(model)
    rng = np.random.default_rng(11)
    for name, flags, vq, _ in S.STACK_CASES:
        m_, st = S._wbc_test_stack(model, info, dev, flags, vq)

        def dust(a):
            return a * (1.0 + 1e-7 * torch.as_tensor(
                rng.standard_normal((N,) + tuple(a.shape)),
                dtype=torch.float32, device=dev))

        def tau(x):
            return vmap(lambda y: T.recover_torques(m_, y))(x)
        bt = [T.Task(*[dust(a) for a in t]) for t in st]
        xk = K.fused_hoqp_batched(*bt)
        xp = vmap(K.cascade_plain)(*bt)
        xk0, xp0 = K.fused_hoqp(*st), K.cascade_plain(*st)
        print(f"== {name}: undusted K1 vs plain "
              f"{float((tau(xk0[None]) - tau(xp0[None])).abs().max()):.4f} Nm")
        print(f"  dust moves K1 p50/p90/p99/max "
              f"{_pct((tau(xk) - tau(xk0[None])).abs().amax(1))} Nm; plain "
              f"{_pct((tau(xp) - tau(xp0[None])).abs().amax(1))}; K1 vs "
              f"plain {_pct((tau(xk) - tau(xp)).abs().amax(1))}")
        ok_k = torch.ones(N, dtype=torch.bool, device=dev)
        ok_p = torch.ones(N, dtype=torch.bool, device=dev)
        for lvl, t in enumerate(bt):
            rk = (torch.einsum("bij,bj->bi", t.A, xk) - t.b).norm(dim=1)
            rp = (torch.einsum("bij,bj->bi", t.A, xp) - t.b).norm(dim=1)
            slack = 0.005 * (1 + t.b.norm(dim=1))
            ok_k &= rk < 1.25 * rp + slack
            ok_p &= rp < 1.25 * rk + slack
            print(f"  level {lvl}: K1/plain residual ratio p1/p50/p99 "
                  f"{_pct(rk / rp, (1, 50, 99))}, min "
                  f"{float((rk / rp).min()):.4f}, max "
                  f"{float((rk / rp).max()):.4f}; means K1 "
                  f"{float(rk.mean()):.4f}, plain {float(rp.mean()):.4f}")
        print(f"  residual criterion (1.25x + 0.005 (1 + |b|)): K1 against "
              f"plain holds on {int(ok_k.sum())}/{N}, plain against K1 on "
              f"{int(ok_p.sum())}/{N}")
        x64 = K.cascade_plain(*[T.Task(*[a.double() for a in t])
                                for t in st]).float()
        print(f"  undusted, the float64 plain cascade vs K1 "
              f"{float((tau(xk0[None]) - tau(x64[None])).abs().max()):.4f} "
              f"Nm, vs float32 plain "
              f"{float((tau(xp0[None]) - tau(x64[None])).abs().max()):.4f}")
        d64 = np.array([[float((tau(x[i:i + 1]) - tau(K.cascade_plain(*[
            T.Task(*[a[i].double() for a in t]) for t in bt]).float()[None])
        ).abs().max()) for x in (xk, xp)] for i in range(16)])
        print(f"  16 dusted scenarios, the float64 plain cascade vs K1: "
              f"median {np.median(d64[:, 0]):.4f}, max {d64[:, 0].max():.4f} "
              f"Nm; vs float32 plain: median {np.median(d64[:, 1]):.4f}, "
              f"max {d64[:, 1].max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
