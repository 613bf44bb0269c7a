"""The benchmark's run of one cell, driven by data.

A cell is `workloads/<cell>.json`. It names its configuration
(`configs/<config>.json`), its driver (`drivers/<driver>.py`, one per entry
point of the port that a window drives), the traffic parameters the driver
hands to the generator (`traffic.py`), how each end-to-end metric reduces
the window's steps, its per-layer metrics (`layer_metrics/<metric>.py`,
one reader each), the steps a traced run profiles, and the limits of the
correctness check. Nothing here names a cell, a configuration or a metric.

A run: set-up (the driver builds the program and its inputs from the seed
and warms up the cell's own shapes), a closed-loop window of `seconds`
(each step goes out when the last one is done and ends synchronised),
with `trace` a profiled segment of a few more steps, then the device's
peak memory, the program's state freed, and the comparison with the plain
reference. The last line of standard output is the contract's JSON.
"""
import importlib.util
import json
import math
import os
import statistics
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "qm_control_tpu")


class CellError(RuntimeError):
    """A run that cannot give a result; the message says why."""


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    """Import the file at `path` as a module called `name`."""
    if not os.path.exists(path):
        raise CellError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(root, cell):
    """(workload, config, driver module) of `cell`, found by name under
    the benchmark's folder `root`."""
    wl = load_json(os.path.join(root, "workloads", f"{cell}.json"))
    cfg = load_json(os.path.join(root, "configs", f"{wl['config']}.json"))
    drv = load_module(os.path.join(root, "drivers", f"{wl['driver']}.py"),
                      f"qmbench_driver_{wl['driver']}")
    return wl, cfg, drv


def reader(root, metric):
    """The per-layer reader module of `metric`."""
    return load_module(os.path.join(root, "layer_metrics", f"{metric}.py"),
                       "qmbench_metric_" + metric.replace(".", "_"))


def forbidden_modules():
    """Top-level names of sys.modules that the run must not hold, compared
    whole (qm_control_tpu_torch is not qm_control_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def process_start_wall():
    """Wall-clock time at which this process started (Linux /proc), or
    None where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    hz = os.sysconf("SC_CLK_TCK")
    return time.time() - uptime + start_ticks / hz


def reduce_window(spec, steps):
    """One end-to-end metric from the window's steps [(t0, t1, units,
    tag)]: "rate" (units per second over the whole window), "mean_ms"
    (the window over the steps completed) or "quantile_ms" (the q-th
    quantile of the step latencies, `q` in percent)."""
    span = steps[-1][1] - steps[0][0]
    kind = spec["reduce"]
    if kind == "rate":
        return sum(s[2] for s in steps) / span
    if kind == "mean_ms":
        return 1e3 * span / len(steps)
    if kind == "quantile_ms":
        lat = [1e3 * (s[1] - s[0]) for s in steps]
        if len(lat) < 2:
            return lat[0]
        return statistics.quantiles(lat, n=100, method="inclusive")[
            int(spec["q"]) - 1]
    raise CellError(f"unknown reduction {kind!r}")


def _device_info(device, chips):
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _smi():
    """The card's name and power limit as nvidia-smi prints them, or a
    note that it could not be read."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def run_cell(root, cell, seed, seconds, trace, device="cuda", t_start=None,
             log=sys.stderr):
    """Run `cell` and return the result dict (the contract's last line).
    device="cuda" requires the cards the cell asks for; the tests pass
    "cpu" to drive the rest of a run at their own small sizes."""
    import torch
    t_start = time.time() if t_start is None else t_start
    wl, cfg, drv_mod = find_cell(root, cell)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise CellError("no CUDA device: this benchmark measures the "
                            "port on the card and never falls back to "
                            "the CPU")
        if torch.cuda.device_count() < wl["chips"]:
            raise CellError(f"{cell} needs {wl['chips']} cards, found "
                            f"{torch.cuda.device_count()}")
        print(f"[qmbench] {cell}: {torch.cuda.get_device_name(0)}, "
              f"{torch.cuda.device_count()} device(s), {_smi()}", file=log)
    drv = drv_mod.Driver(cfg, wl, seed, dev)
    drv.warmup()
    setup_s = time.time() - t_start

    steps = []
    t_end = time.perf_counter() + seconds
    while True:
        a = time.perf_counter()
        units, tag = drv.step()
        b = time.perf_counter()
        steps.append((a, b, units, tag))
        if b >= t_end:
            break

    metrics = {}
    result = {"correct": False, "attempted": 0, "failed": 0,
              "metrics": metrics}
    if trace:
        from . import trace as T
        tr, _ = T.capture(lambda: drv.step(traced=True), wl["trace_steps"],
                          cuda=dev.type == "cuda")
        ctx = Context(tr, steps, wl, cfg, root)
        for name in wl["per_layer"]:
            mod = reader(root, name)
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
    else:
        for name, spec in wl["end_to_end"].items():
            metrics[name] = {"value": reduce_window(spec, steps),
                             "unit": spec["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    result["device"] = _device_info(dev, wl["chips"])
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = T.breakdown(tr)
    result["samples"] = len(steps)
    attempted, failed = drv.counts()
    drv.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    result["attempted"], result["failed"] = attempted, failed
    result["correct"] = bool(checks) and all(
        _within(c["value"], c["limit"]) for c in checks.values())
    result["checks"] = checks
    return result


def _within(value, limit):
    return isinstance(value, (int, float)) and math.isfinite(value) \
        and value <= limit


class Context:
    """What a per-layer reader reads: the profiled segment's trace, the
    untraced window's steps [(t0, t1, units, tag)], the cell and its
    configuration, and the benchmark's folder."""

    def __init__(self, trace, steps, workload, config, root):
        self.trace = trace
        self.steps = steps
        self.workload = workload
        self.config = config
        self.root = root


def report(result, log=sys.stderr):
    """Print the compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        ok = "ok" if _within(c["value"], c["limit"]) else "OVER"
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=log)
    print(f"[check] correct {result['correct']}", file=log)
    log.flush()
    for c in result["checks"].values():     # JSON has no NaN or infinity
        if isinstance(c["value"], float) and not math.isfinite(c["value"]):
            c["value"] = repr(c["value"])
    print(json.dumps(result), flush=True)
