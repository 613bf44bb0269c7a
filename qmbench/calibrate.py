"""The readings that the limits of a cell's check are set from:

    python3 qmbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 5

In one process, for each seed of --seeds: the port runs the cell's
set-up, warm-up and a short window at the cell's own size, and the check
reads its numbers against the plain reference (the lower readings); for
each seed of --control-seeds, the control (the same reference in
float32 with TF32 products, on the card, put in the port's place) is
read the same way (the upper readings). One JSON line per reading; the
benchmark's own runs never run this. Needs the card, as run.py does.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def readings(cell, seed, seconds, control, device="cuda", root=HERE):
    """(The check's numbers of one seed, the port's or the control's; the
    driver's per-tick detail of them where it keeps one.)"""
    import torch
    from qmbench import harness
    wl, cfg, drv_mod = harness.find_cell(root, cell)
    drv = drv_mod.Driver(cfg, wl, seed, torch.device(device))
    if control:
        drv.control()
    else:
        drv.warmup()
        t_end = time.perf_counter() + seconds
        while time.perf_counter() < t_end:
            drv.step()
        drv.release()
    got = drv.readings()
    return got, getattr(drv, "detail", None)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[calibrate] no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    for kind, seeds in (("port", args.seeds), ("control",
                                               args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            t0 = time.perf_counter()
            got, detail = readings(args.workload, int(s), args.seconds,
                                   kind == "control")
            print(json.dumps({"workload": args.workload, "kind": kind,
                              "seed": int(s), "readings": got,
                              "detail": detail,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
