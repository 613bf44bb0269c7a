"""The benchmark's command:

    python3 qmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It measures qm_control_tpu_torch on the
CUDA card of the machine it starts on, and exits non-zero, printing no
result, when there is no card or too few, when the cell cannot run, or
when the process holds JAX or the JAX package once the window has closed.
Build and kernel caches stay inside the checkout (README.md).
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _environment():
    """Fixed cache directories inside the checkout, one intra-op thread,
    and no JAX behind any library."""
    cache = os.path.join(HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    from qmbench import harness
    start = harness.process_start_wall() or T_START
    import torch
    torch.set_num_threads(1)
    try:
        result = harness.run_cell(HERE, args.workload, args.seed,
                                  args.seconds, bool(args.trace),
                                  t_start=start)
    except harness.CellError as e:
        print(f"[qmbench] {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"[qmbench] the process holds {found}: the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
