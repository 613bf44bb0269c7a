"""The one traffic generator: a cell's inputs from its configuration, its
traffic parameters and the seed.

The benchmark makes the inputs and hands the same to the port and to the
plain reference. Each side builds its own structures (targets, mode
schedules, batches) from them with its own code.

Frozen copies, each with its origin (commit 174fa4e):
- `standing`: chip_smoke.py:456-463 `_standing` with
  qm_control_tpu_torch/experiments.py:77-87 `_standing_setup` (the spawn
  state and the 37-dim EE hold target);
- `heights`: chip_smoke.py:1008-1014 `_spread`, the per-scenario base
  height offsets, now drawn from the seed (uniform within +-spread) on
  the device instead of a fixed linspace;
- `fleet_state`: chip_smoke.py:1333-1355 `_bench_batch`'s states (x0 at
  the spawn with the heights added, the warm start X = x0 unperturbed).
"""
import numpy as np
import torch

from .reference.robot import NOMINAL_JOINTS

FOOT_BITS = dict(LF=8, RF=4, LH=2, RH=1)
STANCE = 15


def standing(cfg):
    """(x0 (30,), s (37,)) as float32 / float64 numpy: the spawn state at
    cfg["spawn_height"] and the hold target (base height, joints at the
    spawn, EE position and orientation of cfg["ee_hold"])."""
    q0 = np.asarray([0.0, 0.0, cfg["spawn_height"], 0.0, 0.0, 0.0]
                    + list(NOMINAL_JOINTS), dtype=np.float32)
    s = np.zeros(37)
    s[6:30] = q0
    s[8] = cfg["base_height_target"]
    s[30:37] = cfg["ee_hold"]
    x = s[:30].astype(np.float32)
    x[6:30] = q0
    return x, s


def generator(seed, device):
    """A torch.Generator on `device` seeded from `seed` (any whole number
    that fits in 64 bits once reduced)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def heights(seed, n, spread, device):
    """(n,) base height offsets, uniform within +-spread, from the seed."""
    u = torch.rand(n, generator=generator(seed, device), device=device)
    return (2.0 * u - 1.0) * spread


def fleet_state(cfg, traffic, seed, device):
    """(x (B, 30), x0 (30,)) on `device`: B copies of the spawn state with
    the seed's height offsets on the base height, and the unperturbed
    spawn state that every warm start X begins from."""
    x0, _ = standing(cfg)
    x0 = torch.as_tensor(x0, device=device)
    B = traffic["batch"]
    x = x0[None].expand(B, 30).clone()
    x[:, 8] += heights(seed, B, cfg["height_spread"], device)
    return x, x0


def robot_spawn(cfg, seed):
    """(q0 (24,) float32 numpy): the spawn with the seed's base height
    offset (uniform within +-cfg["height_spread"])."""
    x0, _ = standing(cfg)
    q0 = x0[6:30].copy()
    off = heights(seed, 1, cfg["height_spread"], "cpu")
    q0[2] += float(off[0])
    return q0


def knots(cfg, traffic):
    """(times, [s, s]) of the held target over the traffic's span."""
    _, s = standing(cfg)
    return [0.0, float(traffic["span_s"])], [s, s]


def sample(seed, n, k, first=()):
    """k distinct indices of range(n), drawn from the seed: `first`
    always, the rest at random (sorted)."""
    rng = np.random.default_rng(int(seed) % (2 ** 63) + 1)
    pick = [i for i in first if 0 <= i < n]
    rest = [i for i in range(n) if i not in pick]
    more = max(0, min(k - len(pick), len(rest)))
    pick += [int(i) for i in rng.choice(rest, size=more, replace=False)]
    return sorted(pick)


def mode_number(name):
    """A mode's number from its name: the sum of its feet's bits (8 LF,
    4 RF, 2 LH, 1 RH); STANCE is all four."""
    if name == "STANCE":
        return STANCE
    return sum(FOOT_BITS[f] for f in name.split("_"))


def gait_events(cfg, hi):
    """(event times, modes) of the configuration's gait cycle tiled from
    t = 0 past `hi`: modes[i] holds on [events[i-1], events[i]), stance
    before the first event."""
    cyc = cfg["gait_cycle"]
    rel = cyc["switching_times"]
    period = rel[-1] - rel[0]
    events, modes, t0 = [], [STANCE], 0.0
    while t0 < hi + period:
        for k, name in enumerate(cyc["modes"]):
            events.append(t0 + rel[k] - rel[0])
            modes.append(mode_number(name))
        t0 += period
    return events, modes
