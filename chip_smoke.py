#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qm_control_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each fails loudly; the last stdout line is printed only when all
of them passed; each prints its wall time):
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. build K1 (kernels/csrc/hoqp_fused.cu) with nvcc for sm_90a, and the
     native host-runtime library (native/csrc/qm_native.cpp) with g++;
  3. K1 cold and warm against its plain PyTorch version on the card: 16
     seeded random cascades (as drawn and with feasible bounds) and the
     real stance/trot WBC stacks built by the port's wbc/tasks.py on the
     GPU; beside each, the f32 spread of the cascade (the plain version on
     the CPU against itself on the card, and how far 1e-7 input dust
     moves K1 and the plain version); on the real stacks, two launches of
     K1 on the same inputs, cold and warm, must agree bit for bit; the same
     checks on the MPC-only variant's stance and trot stacks (30/56, 18,
     12 rows: t1 = base height, angular, linear, swing; t2 = contact force)
     with the JAX package's bound between two cascade implementations
     (1.0 Nm stance, 2.0 Nm trot) and phase 3's per-level rule for random
     cascades: its stance optimum is bimodal under f32 roundoff;
  4. the tick path without an MPC stage: ControlLoop.run_ticks for 100
     ticks of the standing configuration at full width (1 kHz ticks, the
     hold policy of 67 nodes, arm_settling_time 0), with the K1 launch
     count reset just before and read just after; the first 10 ticks are
     held against the same ticks with cascade_plain called on the card;
  4a. the MPC on the card: the port's MpcSolver on the golden scenario of
     tests/test_golden.py, held to tests/golden_standing.json at that
     test's bounds; then one cold and one warm mpc_step at full width
     (N = 67) on the trot schedule of standing_ee_hold, on the card and on
     the CPU from the same inputs (cost 1e-3 relative, X 2e-3, W 0.5);
  4b. the main path: experiments.standing_ee_hold(gait="trot",
     duration=0.25, transient=0.0, device="cuda") at full width: warm-up
     solves, 50 MPC periods of settling, 25 of trot, 750 ticks, each with
     one K1 launch (count reset before, read after); every metric finite,
     safe, and the EE errors within the reference's 3.5 mm / 2.6 deg,
     which the JAX package's own run of the same call holds
     (docs/hold_reference_jax.py). It runs in a child process of this
     script, beside phases 3-4a (the host is the bottleneck of both);
  4c. the command-driven experiments at full width, each in a child
     process beside phases 3-4a and 4b (two at a time on a host with
     fewer than 8 cores), each with the K1 count reset before and read
     after and its control ticks counted at the loop:
     traverse_ee_hold(gait="trot", speed=-0.05, max_time=1.0) then one
     ControlLoop.escape; ee_tracking(duration=1.3); disturbance_rejection
     at 25 N held 1.0 s with the MPC's wrench feedthrough on and off. One
     K1 launch per tick in every run; traverse finite and safe, its EE
     errors within the JAX package's run of the call (the larger of 25 %
     and that run's own spread under 1e-7 dust on q0, docs/experiments_
     reference_jax.py; the JAX run itself lands above the reference's
     3.5 mm, so that is printed) and within 2.6 deg; the escape's costs
     finite and no K1 launch in it; ee_tracking's
     EE error and the feedthrough's excursion and `recovered` within the
     JAX runs by the same rule; the excursion with the feedthrough below
     the one without, and at most 120 mm;
  4d. the MPC-only controller variant at full width in a child process
     beside 4b/4c: experiments.mpc_variant_standing(duration=0.75,
     transient=0.5, warmup=5) (500 Hz ticks of LoopConfig(), the pivoted
     WBC cascade as in JAX); no K1 launch, finite, safe, its EE, base
     height and arm-tracking errors within the JAX package's run of the
     call (docs/mpc_variant_reference_jax.py; band as 4c), with the JAX
     test's absolute bounds printed beside;
  4e. K1 on the MPC-only stack in the loop: 10 periods of
     make_mpc_cycle(fused_wbc=True) after 5 warm-up solves, one K1 launch
     per tick, finite torques, safe;
  4f. the pivoted cascade (wbc/hoqp.py) against K1 per level,
     lexicographically (at the first level whose objectives differ by more
     than the bound, widened by twice the pivoted cascade's own move under
     1e-7 dust, the pivoted one is the better) on the real stance and trot
     stacks and on the stacks of 10 ticks of LoopConfig(fused_wbc=False)
     (no K1 launch in those ticks); make_batched_wbc(cascade="hoqp") at
     B = 256 against the benchmark's plain float64 cascade on the same
     levels (qmbench/reference/wbc.py): per gait the median torque gap
     within the JAX package's cross-cascade bounds (1.0 Nm stance, 2.0 Nm
     trot, tests/test_kernels.py) and each level's mean residual within
     1.05x; make_batched_wbc(cascade="fused") (one K1 launch of 256
     blocks) printed against both; then 16 of those stacks one at a time
     through the graph runner "hoqp" (wbc.pivoted_runner, as
     make_mpc_cycle's ticks call it: eager, captured, then replayed),
     equal bit for bit to hoqp_solve on every stack, per gait the
     largest torque gap to the reference within the same bounds, the
     runner's counts, and one cascade's CUDA-event ms and kernels eager
     and replayed;
  4g. the hardware seam at full width in a child process beside 4b-4d
     (runtime/hw.py over SimHardware with 2 plant substeps per 500 Hz
     tick, the spawn at 0.38 m, the hold target, stance, N = 67):
     (a) HardwareLoop(async_mpc=False) for 100 ticks (20 MPC periods):
     one K1 launch per tick (count reset before, read after), every
     torque finite and within model.joint_effort + 1e-3, the base height
     within 0.06 m of 0.38 (tests/test_hw.py's bounds), and the final
     base height and the largest |tau| within the JAX package's run of
     the call (the larger of 25 % and that run's spread under 1e-7 dust
     on q0, docs/hw_reference_jax.py); (b) HardwareLoop(async_mpc=True,
     mpc_freq=100): start() receives the initial policy, 4 baseline
     ticks, run_paced(50) at 500 Hz, 5 ticks after stop(): the worker's
     solve count grows in the paced window and the worker thread
     launches no K1, the control thread launches one per tick, torques
     finite and within the limits, the robot up, the paced window within
     tests/test_hw.py's self-calibrating budget (50 (1/500 + 3 tick) +
     1 s), stop() raises nothing and the thread is gone; printed, not
     gated: the tick ms with the worker stopped and with it solving, the
     worker's solves per second, the overruns, whether SCHED_FIFO was
     granted; (c) imu_estimator_update on the card against the CPU on the
     same inputs, within 1e-5;
  5. times with CUDA events after warm-up: ms per tick (and by
     utils.profiling.chained_latency), K1 ms per launch
     (cold, and warm from a warm buffer; and on the MPC-only stack), the
     plain version's ms, and the bound of K1's work on an H100; the
     pivoted cascade's ms per call; the parallel Riccati
     (SqpSettings(parallel_riccati=True)) warm solve beside the serial one
     (cost within 1e-2 relative, W within 5e-3 of 1 + |W|,
     tests/test_pariccati.py's bounds) and its gains on a random LQ at
     nx = nw = 30, N = 67 against the serial sweep (5e-3 relative);
     iLQR exact on the LQR toy of tests/test_ilqr.py (1e-3); a
     torch.profiler view of one MPC period of ticks; the host time of each
     tick layer; the MPC solve (warm-started, N = 67, median of 9, and
     once with unrolled_ops=False), ms per MPC cycle (1 solve + 10 ticks),
     the host syncs of one cycle, and a profile of one solve (kernels,
     device ms, busy share, host ms of linearization, Riccati sweep and
     line search), for the serial and the parallel sweep; the pivoted
     cascade's kernels and device busy share per call;
  3b. K1 with grid = B: 256 real stance/trot stacks (the phase-3 stacks
     with 1e-7 relative dust each) in one launch against 256 single
     launches, bit for bit, cold and warm, and against
     vmap(cascade_plain) on the card (the median torque gap within
     phase 3's bounds, each level's mean residual within 1.05x; checked
     beside phases 3-4a); after phase 5, K1's time per launch at
     B = 1, 132, 256, 1024, 4096 beside its bound;
  6. the batched MPC (parallel.make_batched_mpc_step) on bench.py's
     problem (QmConfig(): N = 67, 1 SQP iteration, trot, the hold target,
     x0 at 0.38 m), B = 256 with heights spread over +-0.01 m: every cost
     finite and not all equal, scenarios 0 and B-1 against an unbatched
     mpc_step on the card (cost 1e-3 relative, X 2e-3, W 0.5 N), for the
     first step (eager) and for step 14 (replayed from its CUDA graphs);
     solves/s by bench.py's method (2 untimed steps, 10 timed), kernels
     and device time of one step, peak memory; with
     parallel_riccati=True (eager throughout), the first step and the
     fifth, scenario 0 against its unbatched solve by the same rule, and
     its time;
  7. the batched closed-loop cycle (parallel.make_batched_cycle) at full
     width, B = 256 carries with the same height spread, trot, 1 kHz
     ticks: one warm-up solve, then 3 cycles with the counts reset before
     and read after (one K1 launch of 256 blocks per tick); every metric
     finite, every scenario safe; the unperturbed scenario after one
     cycle against the single-scenario cycle on the card within phase
     4's rule (six dust draws); no synchronizing call in a warm batched
     cycle; ms per batched cycle;
  8. experiments.batched_rollouts at N = 67, batch 256, 5 steps:
     finite_fraction 1.0.
  9. scale-out (parallel/mesh.py, parallel/distributed.py) on bench.py's
     problem (phase 6's batch, B = 256 global). Its gates run while the
     4b-4g children run (after 4f): (a) one rank over NCCL in this
     process (make_mesh()): sharded_fleet_step and sharded_mpc_step bit
     for bit the unsharded make_batched_mpc_step on the same batch (every
     leaf of batch' and policy), mean_cost within 1e-5 relative of
     policy.cost.mean(), the sharded dry-run cycle (the JAX package's
     dryrun_multichip: the fleet step, policy evaluation, the batched
     WBC) one K1 launch of 256 blocks with every torque finite and within
     model.joint_effort + 1e-3 and K1 against vmap(cascade_plain) on the
     same stacks by phase 3b's rule (median torque gap within the stack
     case's cold bound, level residual means within 1.05x + slack),
     sharded_mean over arange(2n) within 1e-5 of its closed form; (b) two
     ranks sharing the card over gloo with CUDA tensors (128 scenarios
     each), started by torch.distributed.run: each rank's dry run by
     (a)'s gates on its own stacks with one K1 launch of 128 blocks, its
     gathered costs (mesh.gather_rows) equal to its rows, one warm
     sharded batched cycle (phase 7's configuration on shard_scenarios
     carries) one launch of 128 blocks per tick with every metric finite
     and every scenario safe; rank 0 recomputes the one-rank run (its
     digest equal to (a)'s, bit for bit) and holds the gathered rows of
     both ranks against it by phase 6's rule (cost 1e-3 relative, X
     2e-3, W 0.5 N) and the dry run's K1 torques by phase 3b's median
     rule (the plain version's gap on the same inputs printed beside);
     mean_cost equal on both ranks and within 1e-5 relative of (a)'s;
     (c) two NCCL ranks, one card each, by (b)'s gates, and K1 on card 1
     after card 0 in one process bit for bit, only where the machine has
     two cards (else a line says why not). After phase 8, with no other
     child running, printed, not gated: the sharded fleet step at
     B = 1024 global on one rank (and at 512) against two ranks sharing
     the card with half the host's cores as threads each (solves/s by
     bench.py's method, the all-reduce's ms, peak memory per rank);
     `--distributed` adds two ranks with all the cores each.
The profiles of phases 5 and 6 run last: the profiler leaves tracing on
and slows what runs after it (phase 5 prints the tick after it). A
[kernels] line lists K1's launches on every path.
Without a CUDA device it exits non-zero before printing any result.

    python3 chip_smoke.py --mpc-batch B

runs phase 6 alone at B scenarios (the B = 1024 and 4096 probes);
`--main-path`, `--experiment NAME`, `--mpc-variant` and `--hardware` are
phases 4b, 4c, 4d and 4g alone; `--distributed` is phases 1-2 and 9
alone (`--scaleout-rank` is one of its ranks under torch.distributed.run).
"""
import json
import os
import statistics
import subprocess
import sys
import time

H100_F32_FLOPS = 67e12      # f32 outside the tensor cores, SXM, 700 W
H100_BYTES_PER_S = 3.35e12  # HBM3
TICKS = 100                 # phase 4
# phase 4b: the main path. The JAX package's standing_ee_hold uses 25
# warm-up solves; an eager solve on the card takes ~3 s, so the smoke run
# cuts them to 5 to stay inside its time limit.
HOLD = dict(gait="trot", duration=0.25, transient=0.0, warmup=5)
HOLD_TICKS = (50 + 25) * 10         # settling + trot periods x 10 ticks
# the JAX package's own run of standing_ee_hold(gait="trot",
# duration=0.25, transient=0.0, warmup=25) on the CPU
# (docs/hold_reference_jax.py); it holds the reference's gates, so the
# port is held to them
JAX_HOLD = dict(ee_pos_err_max_mm=2.5492957793176174,
                ee_ori_err_max_deg=0.05422760989949518)
HOLD_GATES = dict(ee_pos_err_max_mm=3.5, ee_ori_err_max_deg=2.6)
# phase 4c: the command-driven experiments at full width, cut in depth
# (5 warm-up solves; the traverse to 1.0 s, when its ramped command has
# walked one chunk; the disturbance held 1.0 s: of the holds tried, 0.5,
# 1.0 and 1.5 s, the shortest at which the JAX package's run separates the
# feedthrough from the WBC alone, PERF.md section 4)
EXPERIMENTS = {
    "traverse": ("traverse_ee_hold",
                 dict(gait="trot", speed=-0.05, max_time=1.0, warmup=5)),
    "tracking": ("ee_tracking", dict(duration=1.3, warmup=5)),
    "wrench_on": ("disturbance_rejection",
                  dict(ee_force=25.0, settle=0.2, hold=1.0, release=0.3,
                       warmup=5, settle_band_mm=25.0,
                       mpc_wrench_feedthrough=True)),
    "wrench_off": ("disturbance_rejection",
                   dict(ee_force=25.0, settle=0.2, hold=1.0, release=0.3,
                        warmup=5, settle_band_mm=25.0,
                        mpc_wrench_feedthrough=False)),
}
# the JAX package's own runs of these calls on the CPU, (value, spread):
# the spread is the largest move of the value under 1e-7 relative dust on
# q0 over three draws (docs/experiments_reference_jax.py)
JAX_EXPERIMENTS = {
    "traverse": dict(ee_pos_err_max_mm=(4.714813083410263,
                                        0.07854867726564407),
                     ee_ori_err_max_deg=(0.34950448840882836,
                                         0.008399905379499195)),
    "tracking": dict(ee_pos_err_max_mm=(22.6923817515423,
                                        0.03601964115420486)),
    "wrench_on": dict(ee_excursion_max_mm=(15.327118337154388,
                                           0.18096249550580978),
                      recovered=True),
    "wrench_off": dict(ee_excursion_max_mm=(31.657513231039047, None)),
    # phase 4d (docs/mpc_variant_reference_jax.py, draw 0 and draws 1-3)
    "variant": dict(ee_pos_err_max_mm=(6.692319642752409,
                                       0.00361492857336998),
                    base_height_err_max_mm=(13.873243331909201,
                                            0.003725290298461914),
                    arm_track_err_max_rad=(0.0021691322326660156,
                                           4.76837158203125e-07)),
    # phase 4g(a) (docs/hw_reference_jax.py, draw 0 and draws 1-3)
    "hardware": dict(base_height_final=(0.3780054748058319,
                                        8.544325828552246e-05),
                     tau_abs_max=(30.890445709228516, 6.137222290039062)),
}
# phase 4d: the MPC-only variant at full width, cut in depth (JAX default
# 2.0 s and 25 warm-up solves). f32 time lands just under 0.75 s after
# three 0.25 s chunks, so a fourth runs, in the JAX run as in the port:
# 100 periods, 500 ticks at 500 Hz
VARIANT = dict(duration=0.75, transient=0.5, warmup=5)
# tests/test_mpc_loop.py's absolute bounds, printed beside the gate
VARIANT_BOUNDS = dict(ee_pos_err_max_mm=120.0, base_height_err_max_mm=60.0,
                      arm_track_err_max_rad=0.2)
MPC_K1_CYCLES = 10          # phase 4e
HW_TICKS = 100              # phase 4g: 20 MPC periods at 500 Hz
HW_PACED = 50               # run_paced's ticks in 4g(b)
CHILD_TIMEOUT_S = 780       # phases 4b-4d, counted from the end of 4f
ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 256                 # phases 3b, 6-8: bench.py's batch
K1_BATCHES = (1, 132, 256, 1024, 4096)   # phase 3b's timed grid sizes
BATCH_CYCLES = 3            # phase 7
SCALE_TIMED_BATCH = 1024    # phase 9: solves/s, one rank against two
SCALE_CHILD_TIMEOUT_S = 300  # each rank of phase 9(b) and 9(c)


def _smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps=7, inner=1):
    """Median over `reps` of the CUDA-event time of `inner` calls, per call."""
    import torch
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def _random_cascade(rng, nx=36, nv=56):
    """The draws of tests/test_kernels.py:_random_cascade, in numpy."""
    import numpy as np
    A0 = rng.standard_normal((30, nx)).astype(np.float32) * 0.5
    b0 = rng.standard_normal(30).astype(np.float32)
    D = rng.standard_normal((nv, nx)).astype(np.float32) * 0.3
    f = rng.standard_normal(nv).astype(np.float32) * 0.5 + 2.0
    A1 = rng.standard_normal((22, nx)).astype(np.float32) * 0.5
    b1 = rng.standard_normal(22).astype(np.float32)
    A2 = rng.standard_normal((14, nx)).astype(np.float32) * 0.5
    b2 = rng.standard_normal(14).astype(np.float32)
    e, ev = np.zeros((0, nx), np.float32), np.zeros(0, np.float32)
    return [(A0, b0, D, f), (A1, b1, e, ev), (A2, b2, e, ev)]


# the real WBC stacks of tests/test_kernels.py:wbc_stacks: (name, contact
# flags, joint velocity, torque bounds (Nm) of the K1-vs-plain comparison,
# cold and warm). Trot: the bound of the CPU tests (its optimum wanders
# +-0.7 Nm under last-bit input dust, tests/test_kernels.py:185-193).
# Stance: the CPU tests' 0.1 Nm, except cold at 0.15 Nm, just above the
# 0.101 Nm by which K1 and the plain version differ on this stack on an
# H100 (the same in every run); the stance optimum too moves up to ~0.9 Nm
# under 1e-7 input dust, for either implementation (phase 3 prints it).
STACK_CASES = (("stance", (1., 1., 1., 1.), 0.0, (0.15, 0.1)),
               ("trot", (1., 0., 0., 1.), 0.05, (2.0, 2.0)))
DUST_DRAWS = 8


def _wbc_test_stack(model, info, dev, flags, vq, mpc_only=False):
    """(WbcData, [t0, t1, t2]) of tests/test_kernels.py:wbc_stacks, built
    by the port on `dev` at default_q(base_pos=(0, 0, 0.4)); mpc_only: the
    MPC-only variant's levels (t1 = base height, angular, linear, swing;
    t2 = contact force) with the same gains."""
    import torch
    from qm_control_tpu_torch.models import default_q
    from qm_control_tpu_torch.wbc import tasks as T
    x = torch.zeros(30, device=dev)
    x[6:30] = torch.as_tensor(default_q(base_pos=(0, 0, 0.4)),
                              dtype=torch.float32, device=dev)
    z30 = torch.zeros(30, device=dev)
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=dev)
    m_, d_ = T.compute_wbc_data(model, info, x, z30, z30, x[6:30],
                                torch.full((24,), vq, device=dev),
                                torch.tensor(flags, device=dev),
                                torch.tensor(0.002, device=dev))
    t0 = (T.floating_base_eom_task(m_) + T.torque_limits_task(m_, tau_max)
          + T.no_contact_motion_task(m_) + T.friction_cone_task(m_, 0.5))
    height = T.base_height_task(m_, d_, 100., 10.)
    angular = T.base_angular_task(m_, d_, 100., 10.)
    linear = T.base_linear_task(m_, d_, 100., 10.)
    swing = T.swing_leg_task(m_, d_, 100., 10.).scaled(100.)
    force = T.contact_force_task(m_, z30)
    if mpc_only:
        return m_, [t0, height + angular + linear + swing, force]
    t1 = (height + angular + T.ee_linear_task(m_, d_, 100., 10.)
          + T.ee_angular_task(m_, d_, 100., 10.) + swing)
    return m_, [t0, t1, force + linear]


def _objectives(tasks, x):
    """Per-level objectives of the lexicographic cascade at x: level 0's
    0.5 |A0 x - b0|^2 + 0.5 |v|^2 with v = max(0, D x - f) the least
    slack, then each lower level's residual norm ||A_l x - b_l||."""
    r = _levels(tasks, x)
    v = (tasks[0].D @ x - tasks[0].f).clamp(min=0.0)
    return [0.5 * r[0] ** 2 + 0.5 * float(v @ v)] + r[1:]


def _pivoted_ok(tasks, xh, xk, spread):
    """The pivoted cascade's x (xh) against K1's (xk) on one stack,
    lexicographically: at the first level whose objectives differ by more
    than 0.2 max(|o|, 1) + 0.6 (the bound of the repo's two-implementation
    test) plus twice `spread` (the pivoted cascade's own move of that
    objective under 1e-7 dust), the pivoted one must be the better.
    Returns (ok, pivoted objectives, K1 objectives)."""
    oh, ok_ = _objectives(tasks, xh), _objectives(tasks, xk)
    for a, b, sp in zip(oh, ok_, spread):
        tol = 0.2 * max(abs(b), 1.0) + 0.6 + 2.0 * sp
        if a > b + tol:
            return False, oh, ok_
        if a < b - tol:
            break
    return True, oh, ok_


def _pivoted_spread(tasks, xh, dusted, draws):
    """How far 1e-7 dust on the stack moves the pivoted cascade's
    objectives from those of xh, its solution (max over `draws` draws)."""
    from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
    o = _objectives(tasks, xh)
    spread = [0.0] * len(o)
    for _ in range(draws):
        od = _objectives(tasks, hoqp_solve(dusted(tasks)))
        spread = [max(s, abs(a - b)) for s, a, b in zip(spread, od, o)]
    return spread


def _levels(tasks, x):
    """Per-level task residual norms ||A_l x - b_l||."""
    return [float((t.A @ x - t.b).norm()) for t in tasks]


def _lexicographic_ok(tasks, xk, xp):
    """K1 (xk) against plain (xp) on a degenerate cascade."""
    ok_, ok_k = _levels(tasks, xp), _levels(tasks, xk)
    if abs(ok_k[0] - ok_[0]) > 1e-3 * (1.0 + ok_[0]):
        return False
    for ok_l, ok_kl in zip(ok_[1:], ok_k[1:]):
        tol = 0.2 * max(abs(ok_l), 1.0) + 0.6
        if ok_kl > ok_l + tol:
            return False
        if ok_kl < ok_l - tol:
            return True
    return True


def _k1_work(ma0, nv, ma1, ma2, iters, nx=36):
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


def _standing():
    """(x (30,), s (37,)): the spawn state at 0.38 m and the hold target
    of experiments._standing_setup."""
    from qm_control_tpu_torch.experiments import _standing_setup
    _, _, q0, s = _standing_setup(None)
    x = s[:30].astype("float32")
    x[6:30] = q0
    return x, s


def _hold_problem(dev):
    """(target, mode schedule) of standing_ee_hold(gait="trot") on `dev`:
    the hold target and stance with the trot inserted at 0.5 s."""
    from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    _, s = _standing()
    gs = GaitSchedule(GAIT_LIBRARY["stance"])
    gs.insert_template(GAIT_LIBRARY["trot"], 0.5)
    return (target_from_knots([0.0, 5.25], [s, s], device=dev),
            gs.mode_schedule(0.0, 3.0, device=dev))


def _solve_pair(ocp, model, info, cfg, dev, settings):
    """Cold mpc_step at t = 0.45 s (the horizon crosses into the trot),
    then warm 10 ms later from a perturbed state, at full width."""
    import numpy as np
    import torch
    from qm_control_tpu_torch.mpc.mpc import mpc_step
    x0, _ = _standing()
    x1 = x0.copy()
    x1[:3] += np.float32([0.02, -0.01, 0.01])
    target, ms = _hold_problem(dev)
    N = cfg.mpc.num_nodes
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.zeros((), **f32)
    cold = mpc_step(ocp, model, info, cfg, settings, torch.tensor(0.45, **f32),
                    torch.tensor(x0, device=dev), target, ms,
                    torch.zeros(N, 30, **f32), torch.zeros(N + 1, 30, **f32),
                    z, torch.ones((), dtype=torch.bool, device=dev))
    args = (torch.tensor(0.46, **f32), torch.tensor(x1, device=dev), target,
            ms, cold.W, cold.X, torch.tensor(0.01, **f32),
            torch.zeros((), dtype=torch.bool, device=dev))

    def warm(st=settings):
        return mpc_step(ocp, model, info, cfg, st, *args)
    return cold, warm(), warm


def main_path():
    """Phase 4b, run as `chip_smoke.py --main-path` in a child process:
    prints one JSON line with standing_ee_hold's result, the wall time and
    the K1 launches of the run."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch.experiments import standing_ee_hold
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    K.build()                      # the parent built it: found on disk
    torch.cuda.synchronize()
    K.launch_count = 0
    t0 = time.perf_counter()
    res = standing_ee_hold(**HOLD, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_count
    arrays = res.pop("log").as_arrays()
    res["finite"] = bool(all(np.isfinite(v).all() for v in arrays.values()
                             if v.dtype.kind == "f"))
    res.update(launches=launches, wall_s=wall,
               logged_cycles=int(len(arrays["t"])))
    print(json.dumps({"main_path": res}))
    return 0


def experiment_child(name):
    """Phase 4c, run as `chip_smoke.py --experiment NAME` in a child
    process: one call of EXPERIMENTS[name] on the card with the K1 launch
    count reset just before and read just after, and the control ticks it
    ran counted at the loop (cycles the experiment asked for x ticks per
    cycle). The traverse child then runs ControlLoop.escape on a carry
    after 5 warm-up solves. Prints one JSON line {"experiment": name,
    "result": ...}."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch import experiments as E
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.runtime.loop import ControlLoop

    class Counted(ControlLoop):
        ticks = 0

        def run(self, carry, target, ms, num_cycles, log=None):
            Counted.ticks += num_cycles * self.loop_cfg.ticks_per_cycle
            return super().run(carry, target, ms, num_cycles, log=log)

    E.ControlLoop = Counted
    fn, kw = EXPERIMENTS[name]
    K.build()                      # the parent built it: found on disk
    torch.cuda.synchronize()
    K.launch_count = 0
    t0 = time.perf_counter()
    res = getattr(E, fn)(**kw, device="cuda")
    torch.cuda.synchronize()
    res.update(launches=K.launch_count, ticks=Counted.ticks,
               wall_s=time.perf_counter() - t0)
    log = res.pop("log", None)
    res.pop("cycle_timer", None)
    if log is not None:
        res["finite"] = bool(all(np.isfinite(v).all()
                                 for v in log.as_arrays().values()
                                 if v.dtype.kind == "f"))
    if name == "traverse":
        # ControlLoop.escape in the traverse's loop configuration, on the
        # hold problem (stance, trot from 0.5 s) after 5 warm-up solves:
        # two deep solves of 12 SQP iterations, no tick
        from qm_control_tpu_torch.experiments import (_default_cfg,
                                                      _loop_cfg,
                                                      _standing_setup)
        model, info, q0, _ = _standing_setup(None)
        loop = ControlLoop(model, info, _default_cfg(), _loop_cfg(1000.0),
                           device="cuda")
        target, ms = _hold_problem(torch.device("cuda"))
        carry = loop.warmup(loop.init_carry(q0), target, ms, num_solves=5)
        K.launch_count = 0
        t0 = time.perf_counter()
        _, escaped = loop.escape(carry, target, ms)
        costs = [float(c) for c in loop.escape_costs]
        res["escape"] = dict(escaped=escaped, cold_cost=costs[0],
                             warm_cost=costs[1], launches=K.launch_count,
                             wall_s=time.perf_counter() - t0)
    print(json.dumps({"experiment": name, "result": res}))
    return 0


def variant_child():
    """Phase 4d, run as `chip_smoke.py --mpc-variant` in a child process:
    mpc_variant_standing(**VARIANT) on the card with the K1 launch count
    reset just before and read just after, and its control ticks counted
    at the loop. Prints one JSON line {"mpc_variant": ...}."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch import experiments as E
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.runtime.mpc_loop import MpcControlLoop

    class Counted(MpcControlLoop):
        ticks = 0

        def run(self, carry, target, ms, num_cycles, log=None):
            Counted.ticks += num_cycles * self.loop_cfg.ticks_per_cycle
            return super().run(carry, target, ms, num_cycles, log=log)

    E.MpcControlLoop = Counted
    K.build()          # the parent built it: found on disk (a K1 launch
    torch.cuda.synchronize()      # would be counted, not fail)
    K.launch_count = 0
    t0 = time.perf_counter()
    res = E.mpc_variant_standing(**VARIANT, device="cuda")
    torch.cuda.synchronize()
    arrays = res.pop("log").as_arrays()
    res.update(launches=K.launch_count, ticks=Counted.ticks,
               periods=int(len(arrays["t"])),
               wall_s=time.perf_counter() - t0,
               finite=bool(all(np.isfinite(v).all() for v in arrays.values()
                               if v.dtype.kind == "f")))
    print(json.dumps({"mpc_variant": res}))
    return 0


def _check_variant(r):
    """Phase 4d's gates on the child's result."""
    args = ", ".join(f"{k}={v!r}" for k, v in VARIANT.items())
    print(f"[4d variant] mpc_variant_standing({args}, device='cuda'): "
          f"{r['wall_s']:.1f} s, {r['periods']} periods, {r['ticks']} "
          f"ticks, K1 launches {r['launches']}, safe {r['safe']}, finite "
          f"{r['finite']}; the JAX test's absolute bounds (printed, not "
          f"gated at this depth): " + ", ".join(
              f"{k} {r[k]:.4f} <= {b}: {r[k] <= b}"
              for k, b in VARIANT_BOUNDS.items()))
    ok = (r["launches"] == 0 and r["ticks"] == 5 * r["periods"] > 0
          and r["finite"] and r["safe"])
    for key in JAX_EXPERIMENTS["variant"]:
        ok &= _within_jax("variant", key, r[key], tag="4d")
    if not ok:
        raise AssertionError("phase 4d: the MPC-only variant misses its "
                             "gate")


def hardware_child():
    """Phase 4g, run as `chip_smoke.py --hardware` in a child process: the
    hardware seam at full width, (a) inline, (b) with the asynchronous MPC
    worker, (c) the IMU estimator on the card against the CPU. Applies the
    phase's gates, then prints one JSON line {"hardware": ...}."""
    import threading
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch import native
    from qm_control_tpu_torch.experiments import (_default_cfg,
                                                  _standing_setup)
    from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    from qm_control_tpu_torch.runtime import estimator as E
    from qm_control_tpu_torch.runtime.hw import HardwareLoop, SimHardware
    K.build()                      # the parent built both: found on disk
    native.load()
    dev = torch.device("cuda")
    cfg = _default_cfg()           # N = 67, 1 iteration, settling 0
    model, info, q0, s = _standing_setup(cfg)
    target = target_from_knots([0.0, 3.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 3.0,
                                                           device=dev)
    lim = np.asarray(model.joint_effort) + 1e-3
    out = {}

    def fresh():
        return dict(ms=[], ok=True, tau=0.0, dz=0.0)

    def recorded(loop, hw):
        """loop.tick, recording each tick's host ms, |tau| max, limits
        and base height into rec["now"] (run_paced calls it too)."""
        inner, rec = loop.tick, {"now": fresh()}

        def tick(*args):
            t0 = time.perf_counter()
            res, x = inner(*args)
            tau = res.torques.cpu().numpy()
            r = rec["now"]
            r["ms"].append(1e3 * (time.perf_counter() - t0))
            r["ok"] &= bool(np.isfinite(tau).all()
                            and (np.abs(tau) <= lim).all())
            r["tau"] = max(r["tau"], float(np.abs(tau).max()))
            r["dz"] = max(r["dz"], abs(float(hw.state.q[2]) - 0.38))
            return res, x
        loop.tick = tick
        return rec

    def run(loop, hw, n):
        for _ in range(n):
            loop.tick(target, ms, hw.state.q[:3], hw.state.v[:3])

    # (a) inline: a solve on every 5th tick, the WBC (K1) on every tick
    hw = SimHardware(model, q0, substeps=2, device=dev)
    loop = HardwareLoop(model, info, cfg, hw, async_mpc=False, device=dev)
    rec = recorded(loop, hw)
    torch.cuda.synchronize()
    K.launch_count = 0
    t0 = time.perf_counter()
    run(loop, hw, HW_TICKS)
    torch.cuda.synchronize()
    a = rec["now"]
    per = loop.ticks_per_mpc
    out["inline"] = dict(
        ticks=HW_TICKS, launches=K.launch_count,
        wall_s=time.perf_counter() - t0, in_limits=a["ok"],
        tau_abs_max=a["tau"], base_height_dev_max=a["dz"],
        base_height_final=float(hw.state.q[2]),
        tick_ms_median=statistics.median(
            [m for i, m in enumerate(a["ms"]) if i % per]),
        solve_tick_ms_median=statistics.median(a["ms"][::per]))

    # (b) the asynchronous MPC worker, paced by the native RatePacer
    hw = SimHardware(model, q0, substeps=2, device=dev)
    loop = HardwareLoop(model, info, cfg, hw, async_mpc=True, mpc_freq=100.0,
                        device=dev)
    rec = recorded(loop, hw)
    torch.cuda.synchronize()
    K.launch_count = 0
    K.launches_by_thread.clear()
    t0 = time.perf_counter()
    loop.start(target, ms, hw.state.q[:3], hw.state.v[:3])
    start_s = time.perf_counter() - t0
    worker = loop.mrt._thread
    first = rec["now"]
    run(loop, hw, 1)                      # first use of the async tick
    rec["now"] = base = fresh()
    run(loop, hw, 3)
    tick_cost = statistics.mean(base["ms"]) / 1e3
    granted = []                          # probed in a thread of its own
    probe = threading.Thread(target=lambda: granted.append(
        native.set_realtime_priority(50)))
    probe.start()
    probe.join()
    n0 = loop.mrt.solve_count
    rec["now"] = paced = fresh()
    t0 = time.perf_counter()
    overruns = loop.run_paced(HW_PACED, target, ms, lambda: hw.state.q[:3],
                              lambda: hw.state.v[:3])
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    solves = loop.mrt.solve_count - n0
    stop_error = None
    try:
        loop.stop()
    except Exception as e:                # reported, and gated below
        stop_error = repr(e)
    rec["now"] = stopped = fresh()
    run(loop, hw, 5)                      # the worker stopped: ticks alone
    segs = (first, base, paced, stopped)
    torch.cuda.synchronize()
    control = K.launches_by_thread.get(threading.get_ident(), 0)
    out["async"] = dict(
        start_s=start_s, baseline_tick_ms=1e3 * tick_cost,
        paced_ticks=HW_PACED, paced_s=elapsed,
        paced_tick_ms=statistics.median(paced["ms"]),
        budget_s=HW_PACED * (1.0 / 500.0 + 3.0 * tick_cost) + 1.0,
        idle_tick_ms=statistics.median(stopped["ms"]),
        solves_in_window=solves, solves_per_s=solves / elapsed,
        overruns=overruns, sched_fifo=bool(granted[0]),
        control_ticks=1 + 3 + HW_PACED + 5, control_launches=control,
        worker_launches=K.launches_by_thread.get(worker.ident, 0),
        launches=K.launch_count,
        in_limits=all(g["ok"] for g in segs),
        tau_abs_max=max(g["tau"] for g in segs),
        base_height_dev_max=max(g["dz"] for g in segs),
        stop_error=stop_error, worker_alive=worker.is_alive())

    # (c) the IMU estimator, card against CPU, on three perturbed spawns
    rng = np.random.default_rng(0)
    est = {d: E.init_imu_estimator(device=d) for d in ("cuda", "cpu")}
    err = 0.0
    for _ in range(3):
        q = np.asarray(q0, np.float32) + rng.uniform(-0.05, 0.05, 24).astype(
            np.float32)
        v = (0.3 * rng.standard_normal(24)).astype(np.float32)
        flags = np.ones(4, np.float32)
        outs = {}
        for d in ("cuda", "cpu"):
            qt, vt = (torch.as_tensor(a, device=d) for a in (q, v))
            quat, gyro = E.imu_from_plant(model, qt, vt)
            rbd, mode, est[d] = E.imu_estimator_update(
                model, est[d], quat, gyro, qt[6:], vt[6:], qt[:3], vt[:3],
                torch.as_tensor(flags, device=d))
            outs[d] = [rbd.cpu(), est[d].zyx_offset.cpu(), mode.cpu()]
        err = max(err, *[float((a.double() - b.double()).abs().max())
                         for a, b in zip(outs["cuda"], outs["cpu"])])
    out["estimator_err"] = err
    _check_hardware(out)
    print(json.dumps({"hardware": out}))
    return 0


def _check_hardware(r):
    """Phase 4g's gates on its result."""
    a, b = r["inline"], r["async"]
    print(f"[4g inline] HardwareLoop(async_mpc=False) {a['ticks']} ticks in "
          f"{a['wall_s']:.1f} s: K1 launches {a['launches']}, torques in "
          f"limits {a['in_limits']}, max|tau| {a['tau_abs_max']:.3f} Nm, "
          f"base height final {a['base_height_final']:.5f} m, max|z - 0.38| "
          f"{a['base_height_dev_max']:.5f} m; tick {a['tick_ms_median']:.1f} "
          f"ms (median), with a solve {a['solve_tick_ms_median']:.1f} ms")
    ok = (a["launches"] == a["ticks"] and a["in_limits"]
          and a["base_height_dev_max"] < 0.06)
    for key in JAX_EXPERIMENTS["hardware"]:
        ok &= _within_jax("hardware", key, a[key], tag="4g")
    print(f"[4g async] start() {b['start_s']:.1f} s; tick with the worker "
          f"solving {b['baseline_tick_ms']:.1f} ms (3 baseline ticks), "
          f"{b['paced_tick_ms']:.1f} ms (run_paced({b['paced_ticks']}), "
          f"{b['paced_s']:.2f} s, budget {b['budget_s']:.2f} s); with the "
          f"worker stopped {b['idle_tick_ms']:.1f} ms; worker "
          f"{b['solves_in_window']} solves in the window "
          f"({b['solves_per_s']:.3f} solves/s); overruns {b['overruns']}; "
          f"SCHED_FIFO granted {b['sched_fifo']}")
    print(f"[4g async] K1 launches: control thread {b['control_launches']} "
          f"in {b['control_ticks']} ticks, MPC worker "
          f"{b['worker_launches']}, all threads {b['launches']}; torques in "
          f"limits {b['in_limits']}, max|tau| {b['tau_abs_max']:.3f} Nm, "
          f"max|z - 0.38| {b['base_height_dev_max']:.5f} m; stop() "
          f"{b['stop_error'] or 'clean'}, worker alive after "
          f"{b['worker_alive']}")
    ok &= (b["solves_in_window"] > 0 and b["worker_launches"] == 0
           and b["control_launches"] == b["control_ticks"] == b["launches"]
           and b["in_limits"] and b["base_height_dev_max"] < 0.06
           and b["paced_s"] < b["budget_s"] and b["stop_error"] is None
           and not b["worker_alive"])
    print(f"[4g estimator] imu_estimator_update card vs CPU: max|d| "
          f"{r['estimator_err']:.3e} (bound 1e-5)")
    ok &= r["estimator_err"] <= 1e-5
    if not ok:
        raise AssertionError("phase 4g: the hardware seam misses its gate")


def mpc_cycle_k1(model, info, dev, cfg):
    """Phase 4e: MPC_K1_CYCLES periods of make_mpc_cycle(fused_wbc=True)
    (LoopConfig(): 5 ticks a period) on the hold target in stance, after
    5 warm-up solves, with the K1 count reset just before and read just
    after: one launch per tick, finite torques, safe. Returns (launches,
    ticks, wall s)."""
    import torch
    from qm_control_tpu_torch.experiments import _standing_setup
    from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    from qm_control_tpu_torch.runtime.loop import LoopConfig
    from qm_control_tpu_torch.runtime.mpc_loop import (MpcControlLoop,
                                                       make_mpc_cycle)
    loop_cfg = LoopConfig()
    _, _, q0, s = _standing_setup(cfg)
    loop = MpcControlLoop(model, info, cfg, loop_cfg, device=dev)
    cycle = make_mpc_cycle(model, info, cfg, loop_cfg, fused_wbc=True,
                           device=dev)
    target = target_from_knots([0.0, 5.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 5.0,
                                                           device=dev)
    carry = loop.warmup(loop.init_carry(q0), target, ms, num_solves=5)
    torch.cuda.synchronize()
    K.launch_count = 0
    t0 = time.perf_counter()
    out = []
    for _ in range(MPC_K1_CYCLES):
        carry, m = cycle(carry, target, ms, cfg.wbc)
        out.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, ticks = K.launch_count, MPC_K1_CYCLES * loop_cfg.ticks_per_cycle
    finite = all(bool(torch.isfinite(m.torques).all()) for m in out)
    safe = bool(out[-1].safe)
    print(f"[4e mpc cycle K1] {MPC_K1_CYCLES} periods of make_mpc_cycle("
          f"fused_wbc=True) at N = {cfg.mpc.num_nodes}: {wall:.1f} s, K1 "
          f"launches {launches} in {ticks} ticks, torques finite {finite}, "
          f"safe {safe}, base height {float(out[-1].base_height):.4f} m")
    if not (launches == ticks and finite and safe):
        raise AssertionError("phase 4e: make_mpc_cycle(fused_wbc=True) "
                             "misses its gate")
    return launches, ticks, wall


def pivoted_vs_k1(model, info, dev, real, cfg, q0, dusted):
    """Phase 4f: the pivoted cascade against K1 (_pivoted_ok) on
    the real stance and trot stacks (four dust draws for the spread) and
    on the stacks of 10 ticks of LoopConfig(fused_wbc=False) (two draws
    each; no K1 launch in those ticks); then _batched_hoqp_check.
    Returns the K1 launches of the pivoted ticks."""
    import torch
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    from qm_control_tpu_torch.wbc import wbc as W
    from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
    from qm_control_tpu_torch.wbc.tasks import recover_torques

    def check(label, tasks, xh, draws):
        xk = K.fused_hoqp(*tasks)
        spread = _pivoted_spread(tasks, xh, dusted, draws)
        ok, oh, ok_ = _pivoted_ok(tasks, xh, xk, spread)
        print(f"[4f pivoted {label}] objectives pivoted "
              f"{[round(v, 4) for v in oh]} K1 {[round(v, 4) for v in ok_]}"
              f"; the pivoted cascade's dust spread "
              f"{[round(v, 4) for v in spread]}: {'in' if ok else 'OUT'}")
        if not (ok and bool(torch.isfinite(xh).all())):
            raise AssertionError(f"phase 4f: the pivoted cascade disagrees "
                                 f"with K1 on {label}")
    for name in ("stance", "trot"):
        (m_, st), _ = real[name]
        xh = hoqp_solve(st)
        check(f"{name} stack", st, xh, 4)
        dtau = float((recover_torques(m_, xh)
                      - recover_torques(m_, K.fused_hoqp(*st))).abs().max())
        print(f"[4f pivoted {name} stack] max|dtau| vs K1 {dtau:.4f} Nm "
              f"(the JAX package's cross-cascade bounds, printed: 1.0 "
              f"stance, 2.0 trot)")
    seen = []
    pivoted = W._pivoted

    def recording(t0, t1, t2):
        x = pivoted(t0, t1, t2)
        seen.append(([t0, t1, t2], x))
        return x
    loop = ControlLoop(model, info, cfg, LoopConfig(control_freq=1000.0,
                                                    fused_wbc=False),
                       device=dev)
    carry = loop.init_carry(q0)
    torch.cuda.synchronize()
    K.launch_count = 0
    W._pivoted = recording
    try:
        t0 = time.perf_counter()
        _, out = loop.run_ticks(carry, 10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        W._pivoted = pivoted
    launches = K.launch_count
    print(f"[4f pivoted ticks] 10 ticks of LoopConfig(fused_wbc=False): "
          f"{wall:.1f} s, K1 launches {launches}, cascades {len(seen)}, "
          f"safe {bool(out.safe.all())}")
    if not (launches == 0 and len(seen) == 10 and bool(out.safe.all())
            and bool(torch.isfinite(out.torques).all())):
        raise AssertionError("phase 4f: the pivoted ticks launched K1 or "
                             "are not finite and safe")
    for i, (tasks, xh) in enumerate(seen):
        check(f"tick {i + 1}", tasks, xh, 2)
    return launches


class _Children:
    """Child processes of this script (`args` each), run in a background
    thread at most `width` at a time, each with its output in a temporary
    file and its wall time kept; `stop` kills whatever still runs."""

    def __init__(self, jobs, width):
        import tempfile
        import threading
        self.jobs = {name: dict(args=args, out=tempfile.TemporaryFile(
            mode="w+"), proc=None, wall=None) for name, args in jobs}
        self._gate = threading.Semaphore(width)
        self._lock = threading.Lock()
        self._stopped = False
        self._threads = [threading.Thread(target=self._one, args=(n,),
                                          daemon=True) for n in self.jobs]
        for th in self._threads:
            th.start()

    def _one(self, name):
        job = self.jobs[name]
        with self._gate:
            with self._lock:
                if self._stopped:
                    return
                t0 = time.perf_counter()
                job["proc"] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     *job["args"]], cwd=ROOT, stdout=job["out"],
                    stderr=subprocess.STDOUT, text=True)
            job["proc"].wait()
            job["wall"] = time.perf_counter() - t0

    def join(self, timeout):
        """{name: (exit code, output lines, wall s)} once all have ended."""
        end = time.perf_counter() + timeout
        for th in self._threads:
            th.join(max(0.0, end - time.perf_counter()))
        out = {}
        for name, job in self.jobs.items():
            if job["wall"] is None:
                raise AssertionError(f"child {name} did not end in time")
            job["out"].seek(0)
            out[name] = (job["proc"].returncode,
                         job["out"].read().splitlines(), job["wall"])
        return out

    def stop(self):
        with self._lock:
            self._stopped = True
        for job in self.jobs.values():
            if job["proc"] is not None and job["proc"].poll() is None:
                job["proc"].kill()
                job["proc"].wait()


def _spread(B):
    """Per-scenario base-height offsets (m): +-0.01 as
    tests/test_parallel.py:_make_batch spreads them, scenario 0 at 0."""
    import numpy as np
    off = np.linspace(-0.01, 0.01, B).astype(np.float32)
    off[0] = 0.0
    return off


def _tile(a, B):
    return a[None].expand(B, *a.shape).clone()


def _k1_batched_check(real, dev):
    """Phase 3b's gates: BATCH real stacks (stance and trot alternating,
    1e-7 relative dust each from a seeded numpy generator) in one grid-B
    launch against B single launches, bit for bit, cold and warm, and
    against vmap(cascade_plain) on the card: the median torque gap
    within phase 3's bounds, and at each level the mean residual of K1
    over the scenarios within 1.05 x the plain one's + 0.005 (1 + |b|).
    Per scenario the gap is printed, not gated: 1e-7 dust moves either
    implementation up to ~2 Nm on these stacks (phase 3 prints 0.19 Nm
    between the two in eight draws), and phase 3's residual criterion
    fails on ~4 % of dusted trot scenarios in either direction.
    Returns (tasks, worst |x_k - x_p|, vmap(cascade_plain) ms)."""
    import numpy as np
    import torch
    from torch.func import vmap

    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.wbc import tasks as T
    rng = np.random.default_rng(11)
    names = ["stance", "trot"] * (BATCH // 2)

    def dust(a):
        return a * (1.0 + 1e-7 * torch.as_tensor(
            rng.standard_normal(tuple(a.shape)), dtype=torch.float32,
            device=dev))
    stacks = [[T.Task(*[dust(a) for a in t]) for t in real[n][0][1]]
              for n in names]
    bt = [T.Task(*[torch.stack([st[lvl][k] for st in stacks])
                   for k in range(4)]) for lvl in range(3)]
    nudged = [T.Task(*[a * (1.0 + 1e-3) for a in t]) for t in bt]

    def one(tasks, i):
        return [T.Task(*[a[i] for a in t]) for t in tasks]
    torch.cuda.synchronize()
    counts = (K.launch_count, K.block_count)
    xb, wb = K.fused_hoqp_batched(*bt, return_warm=True)
    xbw = K.fused_hoqp_batched(*nudged, warm=wb)
    if (K.launch_count - counts[0], K.block_count - counts[1]) != (
            2, 2 * BATCH):
        raise AssertionError("fused_hoqp_batched did not make one grid-B "
                             "launch per call")
    singles = [K.fused_hoqp(*one(bt, i), return_warm=True)
               for i in range(BATCH)]
    singles_w = [K.fused_hoqp(*one(nudged, i), warm=wb[i])
                 for i in range(BATCH)]
    if not (torch.equal(xb, torch.stack([x for x, _ in singles]))
            and torch.equal(wb, torch.stack([w for _, w in singles]))
            and torch.equal(xbw, torch.stack(singles_w))):
        raise AssertionError("K1 with grid = B differs from B single "
                             "launches")
    print(f"[k1 batched] one launch with grid = {BATCH} equals {BATCH} "
          f"single launches bit for bit (cold x and warm_out, warm x)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xp = vmap(K.cascade_plain)(*bt)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    xpw = vmap(lambda a, b, c, w: K.cascade_plain(a, b, c, warm=w))(
        *nudged, wb)
    worst = 0.0
    for k, name in enumerate(("stance", "trot")):
        (m_, _), tols = real[name]
        idx = torch.arange(k, BATCH, 2, device=dev)

        def tau(x):
            return vmap(lambda y: T.recover_torques(m_, y))(x)
        for label, a, b, tasks, tol in (("cold", xb, xp, bt, tols[0]),
                                        ("warm", xbw, xpw, nudged, tols[1])):
            a, b = a.index_select(0, idx), b.index_select(0, idx)
            dtau = (tau(a) - tau(b)).abs().amax(dim=1)
            worst = max(worst, float((a - b).abs().max()))
            # phase 3's residual criterion, counted both ways: on dusted
            # inputs the two implementations land up to +-30 % apart at a
            # level, either one ahead (PERF.md), so neither holds on
            # every scenario; the level means are held instead
            k_ok = torch.ones(len(idx), dtype=torch.bool, device=dev)
            p_ok = torch.ones(len(idx), dtype=torch.bool, device=dev)
            means = []
            for t in tasks:
                A, bb = t.A.index_select(0, idx), t.b.index_select(0, idx)
                r_k = (torch.einsum("bij,bj->bi", A, a) - bb).norm(dim=1)
                r_p = (torch.einsum("bij,bj->bi", A, b) - bb).norm(dim=1)
                slack = 0.005 * (1 + bb.norm(dim=1))
                k_ok &= r_k < 1.25 * r_p + slack
                p_ok &= r_p < 1.25 * r_k + slack
                means.append((float(r_k.mean()), float(r_p.mean()),
                              float(slack.mean())))
            means_ok = all(mk <= 1.05 * mp + sl for mk, mp, sl in means)
            q = np.percentile(dtau.cpu().numpy(), [50, 99, 100])
            print(f"[k1 batched {name} {label}] vs vmap(cascade_plain) over "
                  f"{len(idx)} dusted scenarios: |dtau| median {q[0]:.4f} Nm "
                  f"(bound {tol} Nm), p99 {q[1]:.4f}, max {q[2]:.4f}; level "
                  f"residual means K1 {[round(m[0], 4) for m in means]} "
                  f"plain {[round(m[1], 4) for m in means]} (bound 1.05x); "
                  f"the residual criterion holds for K1 on "
                  f"{int(k_ok.sum())}, for plain on {int(p_ok.sum())}")
            if not (bool(torch.isfinite(a).all()) and means_ok
                    and q[0] < tol):
                raise AssertionError(f"K1 grid={BATCH} {name} {label} "
                                     f"disagrees with vmap(cascade_plain)")
    return bt, worst, plain_ms


def _k1_batched_times(bt, work):
    """Phase 3b's times: K1 ms per launch at each grid size of K1_BATCHES
    (the BATCH stacks repeated), CUDA events, beside the bound of B
    cascades' work. Returns {B: (ms, bound_ms, bound_by)}."""
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.wbc import tasks as T
    flops, nbytes = work
    out = {}
    for B in K1_BATCHES:
        reps = -(-B // BATCH)
        tb = [T.Task(*[a.repeat((reps,) + (1,) * (a.dim() - 1))[:B]
                       for a in t]) for t in bt]
        K.fused_hoqp_batched(*tb)
        ms = _cuda_ms(lambda: K.fused_hoqp_batched(*tb), reps=7, inner=5)
        t_ops, t_bytes = B * flops / H100_F32_FLOPS, B * nbytes / H100_BYTES_PER_S
        out[B] = (ms, 1e3 * max(t_ops, t_bytes),
                  "operations" if t_ops >= t_bytes else "bytes")
        print(f"[k1 batched time] B = {B}: {ms:.3f} ms per launch, "
              f"{1e3 * ms / B:.2f} us per cascade; bound "
              f"{1e3 * out[B][1]:.3f} us ({out[B][2]}: {B} x "
              f"{flops / 1e6:.1f} MFLOP at 67 TFLOP/s)")
    return out


def _batched_hoqp_check(model, info, dev, cfg, B=BATCH):
    """Phase 4f's batch: make_batched_wbc(cascade="hoqp") (vmap of the
    pivoted cascade) on B standing states, stance and trot (joint
    velocity 0.05) alternating, 1e-7 relative dust on q from a seeded
    generator, against the benchmark's plain float64 cascade on the same
    levels (qmbench/reference/wbc.py `cascade`, on the CPU, written apart
    from the port). Per gait the median torque gap within the JAX
    package's cross-cascade bounds (1.0 Nm stance, 2.0 Nm trot,
    tests/test_kernels.py) and at each level the mean residual of the
    pivoted cascade within 1.05 x the reference's + 0.005 (1 + |b|): phase
    3b's criterion, the bounds of two different solvers. K1 on the same
    states (make_batched_wbc(cascade="fused"), one launch of B blocks) is
    printed against both: K1 is float32, and on the stance states it lies
    ~1.4 Nm from the float64 optimum that the pivoted cascade's float64
    level QPs reach. Returns the pivoted batch's wall ms and
    _hoqp_graph_check's numbers."""
    import numpy as np
    import torch
    from torch.func import vmap
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.models import default_q
    from qm_control_tpu_torch.parallel import make_batched_wbc
    from qm_control_tpu_torch.wbc.tasks import recover_torques
    from qm_control_tpu_torch.wbc.wbc import wbc_stack
    from qmbench.reference.wbc import cascade
    rng = np.random.default_rng(13)
    x = torch.zeros(30, device=dev)
    x[6:30] = torch.as_tensor(default_q(base_pos=(0, 0, 0.4)),
                              dtype=torch.float32, device=dev)
    trot = torch.arange(B, device=dev) % 2 == 1
    flags = torch.where(trot[:, None], torch.tensor([1., 0., 0., 1.],
                                                    device=dev),
                        torch.ones(4, device=dev))
    v = 0.05 * trot[:, None].float().expand(B, 24)
    q = x[6:30] * (1.0 + 1e-7 * torch.as_tensor(
        rng.standard_normal((B, 24)), dtype=torch.float32, device=dev))
    z = torch.zeros(B, 30, device=dev)
    args = (_tile(x, B), z, z, q, v, flags, torch.tensor(0.002, device=dev),
            torch.tensor(20.0, device=dev))
    fused = make_batched_wbc(model, info, cfg.wbc, cascade="fused",
                             device=dev)
    hoqp = make_batched_wbc(model, info, cfg.wbc, cascade="hoqp", device=dev)
    torch.cuda.synchronize()
    counts = (K.launch_count, K.block_count)
    rk = fused(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rh = hoqp(*args)
    torch.cuda.synchronize()
    hoqp_ms = 1e3 * (time.perf_counter() - t0)
    if (K.launch_count - counts[0], K.block_count - counts[1]) != (1, B):
        raise AssertionError("the batched WBC comparison did not make one "
                             "grid-B K1 launch and none for the pivoted one")
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=dev)
    m_, stacks = vmap(lambda *a: wbc_stack(model, info, cfg.wbc, tau_max,
                                           *a),
                      in_dims=(0,) * 6 + (None, None))(*args)
    host = [[a.double().cpu() for a in t] for t in stacks]
    xr = torch.stack([cascade(tuple(a[i] for a in host[0]),
                              tuple(a[i] for a in host[1][:2]),
                              tuple(a[i] for a in host[2][:2]))
                      for i in range(B)]).to(dev, torch.float32)
    tau_r = vmap(recover_torques)(m_, xr)
    for k, (name, bound) in enumerate((("stance", 1.0), ("trot", 2.0))):
        idx = torch.arange(k, B, 2, device=dev)
        a, b = rh.x_opt.index_select(0, idx), xr.index_select(0, idx)

        def gap(t1, t2):
            return np.median((t1.index_select(0, idx) - t2.index_select(
                0, idx)).abs().amax(dim=1).cpu().numpy())
        dtau = (rh.torques.index_select(0, idx)
                - tau_r.index_select(0, idx)).abs().amax(dim=1)
        means = []
        for t in stacks:
            A, bb = t.A.index_select(0, idx), t.b.index_select(0, idx)
            r_h = (torch.einsum("bij,bj->bi", A, a) - bb).norm(dim=1)
            r_r = (torch.einsum("bij,bj->bi", A, b) - bb).norm(dim=1)
            means.append((float(r_h.mean()), float(r_r.mean()),
                          float((0.005 * (1 + bb.norm(dim=1))).mean())))
        means_ok = all(mh <= 1.05 * mr + sl for mh, mr, sl in means)
        qs = np.percentile(dtau.cpu().numpy(), [50, 99, 100])
        print(f"[4f batched hoqp {name}] make_batched_wbc(cascade='hoqp') "
              f"vs the float64 reference over {len(idx)} dusted scenarios: "
              f"|dtau| median {qs[0]:.4f} Nm (bound {bound}), p99 "
              f"{qs[1]:.4f}, max {qs[2]:.4f}; level residual means pivoted "
              f"{[round(m[0], 4) for m in means]} reference "
              f"{[round(m[1], 4) for m in means]} (bound 1.05x); K1 grid = "
              f"{B}: median |dtau| {gap(rk.torques, tau_r):.4f} Nm vs the "
              f"reference, {gap(rk.torques, rh.torques):.4f} vs the pivoted")
        if not (bool(torch.isfinite(a).all()) and means_ok
                and qs[0] < bound):
            raise AssertionError(f"phase 4f: the batched pivoted cascade "
                                 f"disagrees with the float64 reference on "
                                 f"{name}")
    print(f"[4f batched hoqp] B = {B}: {hoqp_ms:.1f} ms wall for the "
          f"vmapped pivoted cascade (first call)")
    return hoqp_ms, _hoqp_graph_check(stacks, m_, xr, tau_r)


def _hoqp_graph_check(stacks, m_, xr, tau_r, n=16):
    """Phase 4f's replay: the first n stacks of _batched_hoqp_check's
    batch (stance and trot alternating), one at a time through a graph
    runner "hoqp" (wbc.pivoted_runner, as make_mpc_cycle's ticks call it:
    the first call eager, the second captured, the others replayed),
    against hoqp_solve on the same stack (equal bit for bit on every
    stack, as the replay runs the eager call's kernels on the same
    inputs) and the float64 reference xr (per gait the largest torque gap
    within the batch check's bounds); then one cascade's CUDA-event ms
    and its kernels (torch.profiler), eager and replayed. Returns those
    numbers."""
    import torch
    from torch.func import vmap
    from qm_control_tpu_torch.utils.graphs import counts
    from qm_control_tpu_torch.wbc import wbc as W
    from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
    from qm_control_tpu_torch.wbc.tasks import recover_torques

    def levels(i):
        return [type(t)(*[a[i] for a in t]) for t in stacks]
    cascade = W.pivoted_runner()
    before = counts("hoqp")
    xg, dxs = xr.clone(), []
    for i in range(n):
        xg[i] = cascade(*levels(i))
        dxs.append(float((xg[i] - hoqp_solve(levels(i))).abs().max()))
    dx = max(dxs)
    calls = tuple(b - a for a, b in zip(before, counts("hoqp")))
    dtau = (vmap(recover_torques)(m_, xg)[:n] - tau_r[:n]).abs().amax(dim=1)
    gaps = {name: float(dtau[k::2].max())
            for k, name in enumerate(("stance", "trot"))}
    st = levels(0)
    eager_ms = _cuda_ms(lambda: hoqp_solve(st), reps=5)
    replay_ms = _cuda_ms(lambda: cascade(*st), reps=5)
    k_eager, d_eager = _device_profile(lambda: hoqp_solve(st))
    k_replay, d_replay = _device_profile(lambda: cascade(*st))
    print(f"[4f hoqp graphs] {n} stacks through the runner 'hoqp': "
          f"(eager, captures, replays) {calls}; max|dx| vs hoqp_solve on "
          f"the same stack {dx:.3e} (bound 0, {sum(d == 0.0 for d in dxs)}"
          f" of {n} equal); max |dtau| vs the float64 reference stance "
          f"{gaps['stance']:.4f} Nm (bound 1.0), trot {gaps['trot']:.4f} "
          f"(bound 2.0), median {float(dtau.median()):.4f}; "
          f"counts('hoqp') {counts('hoqp')}")
    print(f"[4f hoqp graphs] one cascade by CUDA events: eager "
          f"{eager_ms:.2f} ms, replayed {replay_ms:.2f} ms (median of 5); "
          f"kernels eager {k_eager} ({d_eager:.3f} ms device), replayed "
          f"{k_replay} ({d_replay:.3f} ms device)")
    if not (calls == (1, 1, n - 1) and dx == 0.0 and gaps["stance"] < 1.0
            and gaps["trot"] < 2.0 and bool(torch.isfinite(xg).all())):
        raise AssertionError("phase 4f: the replayed pivoted cascade did "
                             "not replay, differs from the eager call or "
                             "disagrees with the float64 reference")
    return dict(calls=calls, max_dx_eager=dx, dtau_max=gaps,
                eager_ms=eager_ms, replay_ms=replay_ms, kernels=k_eager,
                device_ms=d_eager, replay_kernels=k_replay,
                replay_device_ms=d_replay)


def _random_lq(rng, N, nx, nw, scale, dev):
    """tests/test_pariccati.py:_random_lq on `dev`."""
    import numpy as np
    import torch

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    A = np.eye(nx) + scale * rng.standard_normal((N, nx, nx))
    B = scale * rng.standard_normal((N, nx, nw))
    lx, lu = rng.standard_normal((N, nx)), rng.standard_normal((N, nw))
    q = rng.standard_normal((N, nx, nx))
    lxx = q @ q.transpose(0, 2, 1) * 0.1 + np.eye(nx)
    r = rng.standard_normal((N, nw, nw))
    luu = r @ r.transpose(0, 2, 1) * 0.1 + np.eye(nw)
    lux = 0.1 * rng.standard_normal((N, nw, nx))
    d = 0.05 * rng.standard_normal((N, nx))
    VxN = rng.standard_normal(nx)
    p = rng.standard_normal((nx, nx))
    VxxN = p @ p.T * 0.1 + np.eye(nx)
    return [t(a) for a in (A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN)]


def _serial_backward(A, B, lx, lu, lxx, luu, lux, d, VxN, VxxN, reg):
    """The serial defect-aware Riccati sweep of solver/sqp.py in plain
    products (tests/test_pariccati.py:_serial_backward)."""
    import torch
    nw = B.shape[-1]
    eye = torch.eye(nw, device=A.device)
    Vx, Vxx, ks, Ks = VxN, VxxN, [], []
    for k in reversed(range(A.shape[0])):
        Vxd = Vx + Vxx @ d[k]
        Qx, Qu = lx[k] + A[k].T @ Vxd, lu[k] + B[k].T @ Vxd
        VA = Vxx @ A[k]
        Qxx, Quu = lxx[k] + A[k].T @ VA, luu[k] + B[k].T @ (Vxx @ B[k])
        Qux = lux[k] + B[k].T @ VA
        kK = torch.linalg.solve_ex(0.5 * (Quu + Quu.T) + reg * eye,
                                   torch.cat([Qu[:, None], Qux], 1))[0]
        kff, Kfb = -kK[:, 0], -kK[:, 1:]
        Vx = Qx + Kfb.T @ (Quu @ kff) + Kfb.T @ Qu + Qux.T @ kff
        KQux = Kfb.T @ Qux
        Vxx = Qxx + Kfb.T @ (Quu @ Kfb) + KQux + KQux.T
        Vxx = 0.5 * (Vxx + Vxx.T)
        ks.append(kff)
        Ks.append(Kfb)
    return torch.stack(ks[::-1]), torch.stack(Ks[::-1])


def parallel_riccati_lq(dev):
    """Phase 5: the associative-scan gains on a random LQ at the MPC's
    width (nx = nw = 30, N = 67) against the serial sweep, within 5e-3
    (1 + |k|) (tests/test_pariccati.py's long-horizon bound). Returns the
    worst relative gap."""
    import numpy as np
    from qm_control_tpu_torch.solver.pariccati import parallel_backward
    args = _random_lq(np.random.default_rng(1), 67, 30, 30, 0.15, dev)
    par = parallel_backward(*args, 1e-6)
    ser = _serial_backward(*args, 1e-6)
    rel = max(float((p - s).abs().max()) / (1.0 + float(s.abs().max()))
              for p, s in zip(par, ser))
    print(f"[riccati LQ] nx = nw = 30, N = 67: parallel vs serial gains "
          f"{rel:.2e} of 1 + |k| (bound 5e-3)")
    if not rel <= 5e-3:
        raise AssertionError("the parallel Riccati gains disagree with the "
                             "serial sweep")
    return rel


def ilqr_lqr(dev):
    """Phase 5: ilqr_solve on the LQR toy of tests/test_ilqr.py on the
    card, one iteration, against the float64 LQR feedback rollout within
    1e-3. Returns the worst gap."""
    import numpy as np
    import torch
    from qm_control_tpu_torch.solver import IlqrSettings, ilqr_solve
    N, dt = 30, 0.1
    A = np.array([[1.0, dt], [0.0, 1.0]])
    B = np.array([[0.5 * dt * dt], [dt]])
    Q, R = np.diag([1.0, 0.1]), np.array([[0.01]])
    At, Bt, Qt, Rt = (torch.as_tensor(m, dtype=torch.float32, device=dev)
                      for m in (A, B, Q, R))
    sol = ilqr_solve(lambda kd, x, w: At @ x + Bt @ w,
                     lambda kd, x, w: 0.5 * x @ Qt @ x + 0.5 * w @ Rt @ w,
                     lambda fd, x: 5.0 * (x @ x), torch.zeros(N, device=dev),
                     0.0, torch.tensor([1.0, 0.0], device=dev),
                     torch.zeros(N, 1, device=dev),
                     IlqrSettings(num_iterations=1, reg=1e-9, alphas=(1.0,)))
    P, Ks = 10.0 * np.eye(2), []
    for _ in range(N):
        K_ = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
        P = Q + A.T @ P @ (A - B @ K_)
        Ks.append(K_)
    x, X, W = np.array([1.0, 0.0]), [np.array([1.0, 0.0])], []
    for K_ in Ks[::-1]:
        W.append(-K_ @ x)
        x = A @ x + B @ W[-1]
        X.append(x)
    err = max(float(np.abs(sol.W.cpu().numpy() - np.array(W)).max()),
              float(np.abs(sol.X.cpu().numpy() - np.array(X)).max()))
    print(f"[ilqr] LQR toy on the card, one iteration: max gap to the "
          f"float64 LQR rollout {err:.2e} (bound 1e-3), alpha "
          f"{float(sol.alpha)}")
    if not err <= 1e-3:
        raise AssertionError("ilqr_solve is not exact on the LQR toy")
    return err


def _bench_batch(B, dev):
    """bench.py's problem for B scenarios on `dev`: the hold target, trot
    from t = 0, x0 at 0.38 m with the heights of _spread(B), warm starts
    W = 0 and X = x0 (bench.py:66-73)."""
    import torch
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    from qm_control_tpu_torch.parallel import BatchScenario
    x0, s = _standing()
    N = QmConfig().mpc.num_nodes
    x = torch.as_tensor(x0, device=dev)
    target = target_from_knots([0.0, 10.0], [s, s], device=dev)
    ms = GaitSchedule(GAIT_LIBRARY["trot"]).mode_schedule(0.0, 10.0,
                                                          device=dev)
    xs = _tile(x, B)
    xs[:, 8] += torch.as_tensor(_spread(B), device=dev)
    return BatchScenario(
        t=torch.zeros(B, device=dev), x=xs,
        target=type(target)(*[_tile(a, B) for a in target]),
        ms=type(ms)(*[_tile(a, B) for a in ms]),
        W_warm=torch.zeros(B, N, 30, device=dev),
        X_warm=_tile(x[None].expand(N + 1, 30), B))


def _device_profile(fn):
    """(kernels, device ms) of one call of fn under torch.profiler, device
    activity only (host events of ~10^5 vmapped ops cost the profiler
    about a minute)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in on_dev)
    return sum(e.count for e in on_dev), dev_us / 1e3


def _replayed(fn):
    """fn(), asserting that it replayed the batched step's CUDA graphs
    (the graph runner "mpc" of mpc/mpc.py solve_runner) rather than ran
    it eagerly or captured."""
    from qm_control_tpu_torch.utils.graphs import counts
    before = counts("mpc")
    out = fn()
    after = counts("mpc")
    if tuple(b - a for a, b in zip(before, after)) != (0, 0, 1):
        raise AssertionError(f"phase 6: the batched step did not replay "
                             f"(eager, captures, replays) {before} -> "
                             f"{after}")
    return out


def batched_mpc(model, info, B=BATCH, parallel=False):
    """Phase 6 at B scenarios, without its profile; returns (its numbers,
    one batched step as a callable). The first step (eager) and a later
    one (replayed from its CUDA graphs) are each held, scenarios 0 and
    B - 1, against the unbatched eager mpc_step. parallel: also steps with
    parallel_riccati=True from the same batch (eager: no CUDA graph), the
    first and the fifth each held by scenario 0 against the unbatched
    parallel solve, and timed."""
    import numpy as np
    import torch
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.mpc.mpc import mpc_step
    from qm_control_tpu_torch.ocp.problem import make_ocp
    from qm_control_tpu_torch.parallel import make_batched_mpc_step
    from qm_control_tpu_torch.solver.sqp import SqpSettings
    dev = torch.device("cuda")
    cfg = QmConfig()
    step = make_batched_mpc_step(model, info, cfg)
    batch = _bench_batch(B, dev)
    ocp = make_ocp(model, info, cfg)
    period = torch.tensor(1.0 / cfg.mpc.mpc_frequency, device=dev)
    cold = torch.zeros((), dtype=torch.bool, device=dev)

    def held(label, b, pol, i, settings):
        """Scenario i of the batched policy pol, from batch b, against the
        unbatched eager solve by phase 6's rule; returns that solve."""
        one = mpc_step(ocp, model, info, cfg, settings, b.t[i], b.x[i],
                       type(b.target)(*[a[i] for a in b.target]),
                       type(b.ms)(*[a[i] for a in b.ms]),
                       b.W_warm[i], b.X_warm[i], period, cold)
        cost = float(pol.cost[i])
        dc = abs(float(one.cost) - cost) / max(1.0, abs(float(one.cost)))
        dx = float((one.X - pol.X[i]).abs().max())
        dw = float((one.W - pol.W[i]).abs().max())
        print(f"[batched mpc B={B}] {label} scenario {i} vs unbatched "
              f"mpc_step: cost {cost:.6f} ({dc:.2e} rel), max|dX| "
              f"{dx:.2e}, max|dW| {dw:.2e}; alpha {float(pol.alpha[i])} / "
              f"{float(one.alpha)}")
        if not (dc <= 1e-3 and dx <= 2e-3 and dw <= 0.5
                and bool(torch.isfinite(pol.cost).all())):
            raise AssertionError(f"batched MPC ({label}) scenario {i} "
                                 f"disagrees with the unbatched solve")
        return one
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    new, pol = step(batch)
    costs = pol.cost.cpu().numpy()
    first_s = time.perf_counter() - t0
    if not (np.isfinite(costs).all() and np.unique(costs).size > 1):
        raise AssertionError(f"batched MPC costs: finite "
                             f"{np.isfinite(costs).mean()}, distinct "
                             f"{np.unique(costs).size}")
    settings = SqpSettings(num_iterations=cfg.mpc.num_iterations)
    for i in (0, B - 1):
        held("first step (eager)", batch, pol, i, settings)
    state = {"b": new}

    def run():
        state["b"], _ = step(state["b"])
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    peak = torch.cuda.max_memory_allocated()
    b = state["b"]                        # after 13 steps
    _, pol_r = _replayed(lambda: step(b))
    for i in (0, B - 1):
        held("step 14 (replayed)", b, pol_r, i, settings)
    out = dict(B=B, step_ms=1e3 * step_s, solves_per_s=B / step_s,
               peak_gib=peak / 2 ** 30, first_step_s=first_s)
    print(f"[batched mpc B={B}] N = {cfg.mpc.num_nodes}, 1 SQP iteration: "
          f"{out['step_ms']:.1f} ms per batched step (mean of 10 after 2 "
          f"untimed), {out['solves_per_s']:.1f} solves/s; peak memory "
          f"{out['peak_gib']:.2f} GiB; first step {first_s:.1f} s")
    if parallel:
        # from the same batch; against the unbatched parallel solve by the
        # rule above. Beside the serial step it lands elsewhere on this
        # problem (W = 0 warm start), as in the JAX package (scenario 0
        # after one iteration: cost 91.04 with the scan, 218.75 serial)
        par = SqpSettings(num_iterations=cfg.mpc.num_iterations,
                          parallel_riccati=True)
        step_p = make_batched_mpc_step(model, info, cfg, par)
        _, pol_p = step_p(batch)
        one = held("parallel_riccati=True, first step (eager)", batch,
                   pol_p, 0, par)
        ms_p = _cuda_ms(lambda: step_p(batch), reps=3)
        out.update(parallel_step_ms=ms_p, parallel_solves_per_s=1e3 * B / ms_p)
        print(f"[batched mpc B={B}] parallel_riccati=True: {ms_p:.1f} ms per "
              f"batched step (median of 3), {1e3 * B / ms_p:.1f} solves/s; "
              f"scenario 0's cost {float(one.cost):.6f}, the serial step's "
              f"{float(pol.cost[0]):.6f}")
        # no CUDA graph: the parallel Riccati runs eagerly (mpc.solve_runner)
        _, pol_pr = step_p(batch)
        held("parallel_riccati=True, step 5 (eager)", batch, pol_pr, 0, par)
    return out, run


def profile_batched_mpc(out, run):
    """Phase 6's device view: kernels and device time of one batched step
    (run after every timed phase: the profiler slows what follows it)."""
    n_k, d_ms = _device_profile(run)
    out.update(kernels=n_k, device_ms=d_ms, busy=d_ms / out["step_ms"])
    print(f"[profile] one batched MPC step, B = {out['B']}: {n_k} kernels, "
          f"{d_ms:.3f} ms device time, device busy "
          f"{100.0 * out['busy']:.1f}% of the {out['step_ms']:.1f} ms step")


def batched_cycle(model, info, dev):
    """Phase 7; returns (launches, blocks, ms per batched cycle)."""
    import warnings

    import numpy as np
    import torch
    from torch.func import vmap
    from torch.utils._pytree import tree_map

    from qm_control_tpu_torch.experiments import _default_cfg
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.models import default_q
    from qm_control_tpu_torch.parallel import make_batched_cycle
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    cfg = _default_cfg()
    loop_cfg = LoopConfig(control_freq=1000.0)
    B, ticks = BATCH, loop_cfg.ticks_per_cycle
    vcycle, make_carries = make_batched_cycle(model, info, cfg, loop_cfg,
                                              device="cuda")
    loop = ControlLoop(model, info, cfg, loop_cfg, device="cuda")
    q0 = default_q(base_pos=(0, 0, 0.38))
    tb = _bench_batch(B, dev)
    target, ms, gains = tb.target, tb.ms, cfg.wbc
    carries = make_carries(q0, B)
    q = carries.plant.q.clone()
    q[:, 2] += torch.as_tensor(_spread(B), device=dev)
    carries = carries._replace(plant=carries.plant._replace(q=q))
    carries = vmap(loop._warmup)(carries, target, ms)     # one solve
    c0 = carries
    torch.cuda.synchronize()
    K.launch_count = K.block_count = 0
    t0 = time.perf_counter()
    out, q_first = [], None
    for _ in range(BATCH_CYCLES):
        carries, m = vcycle(carries, target, ms, gains)
        out.append(m)
        q_first = carries.plant.q[0] if q_first is None else q_first
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, blocks = K.launch_count, K.block_count
    print(f"[batched cycle] B = {B}, {BATCH_CYCLES} cycles of {ticks} "
          f"ticks at N = {cfg.mpc.num_nodes}: {wall:.1f} s wall (first use "
          f"included), K1 launches {launches}, blocks {blocks}")
    if (launches, blocks) != (BATCH_CYCLES * ticks,
                              BATCH_CYCLES * ticks * B):
        raise AssertionError(f"batched cycle: {launches} K1 launches and "
                             f"{blocks} blocks in {BATCH_CYCLES * ticks} "
                             f"ticks of {B} scenarios")
    finite = all(bool(torch.isfinite(v).all()) for m in out for v in m
                 if v.dtype.is_floating_point)
    safe = bool(out[-1].safe.all())
    print(f"[batched cycle] every metric finite {finite}, every scenario "
          f"safe {safe}; EE error over scenarios: max "
          f"{1e3 * float(out[-1].ee_pos_err.max()):.2f} mm")
    if not (finite and safe):
        raise AssertionError("the batched cycle is not finite or not safe")
    # scenario 0 (unperturbed) against the single-scenario cycle on the
    # card after the first cycle (10 ticks, as phase 4); the bound adds
    # twice that cycle's own spread under 1e-7 dust (six draws)
    one = tree_map(lambda a: a[0], (c0, target, ms))
    sc, sm = loop._cycle(*one, gains)
    rng = np.random.default_rng(7)
    band = np.zeros(2)
    for _ in range(6):
        qd = one[0].plant.q * (1.0 + 1e-7 * torch.as_tensor(
            rng.standard_normal(24), dtype=torch.float32, device=dev))
        dc, dm = loop._cycle(one[0]._replace(plant=one[0].plant._replace(
            q=qd)), one[1], one[2], gains)
        band = np.maximum(band, [float((dc.plant.q - sc.plant.q).abs().max()),
                                 float((dm.torques - sm.torques).abs().max())])
    gq = float((q_first - sc.plant.q).abs().max())
    gt = float((out[0].torques[0] - sm.torques).abs().max())
    print(f"[batched cycle] scenario 0 vs the single-scenario cycle after "
          f"one cycle: max|dq| {gq:.3e} (spread {band[0]:.3e}), max|dtau| "
          f"{gt:.3e} Nm (spread {band[1]:.3e})")
    if not (gq <= 2 * band[0] + 1e-4 and gt <= 2 * band[1] + 0.1):
        raise AssertionError("the batched cycle's scenario 0 disagrees with "
                             "the single-scenario cycle")
    state = {"c": carries}

    def cycle():
        state["c"], _ = vcycle(state["c"], target, ms, gains)
    cycle_ms = _cuda_ms(cycle, reps=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cycle()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    flagged = [w for w in caught
               if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"[batched cycle] {cycle_ms:.1f} ms per batched cycle (median of "
          f"2), {1e3 * B / cycle_ms:.1f} scenario-cycles/s; one warm cycle: "
          f"{len(flagged)} synchronizing calls flagged at "
          f"{sorted({f'{w.filename}:{w.lineno}' for w in flagged})}")
    if flagged:
        raise AssertionError("a warm batched cycle reads the device")
    return launches, blocks, cycle_ms


def _within_jax(name, key, value, tag="4c"):
    """|value - JAX's| within the larger of 25 % of JAX's value and the JAX
    run's own spread under 1e-7 dust on q0 (JAX_EXPERIMENTS)."""
    ref, spread = JAX_EXPERIMENTS[name][key]
    band = max(0.25 * abs(ref), spread)
    ok = abs(value - ref) <= band
    print(f"[{tag} {name}] {key} {value:.4f} vs the JAX run's {ref:.4f} "
          f"(band {band:.4f}: 25 % or its dust spread {spread:.4f}): "
          f"{'in' if ok else 'OUT'}")
    return ok


def _check_experiments(res):
    """Phase 4c's gates on the children's results {name: dict}; returns
    the K1 launches of each run."""
    import math

    def finite(r):
        return all(isinstance(v, (bool, str)) or (
            v is not None and math.isfinite(v)) for v in r.values()
            if not isinstance(v, dict))
    for name, r in res.items():
        fn, kw = EXPERIMENTS[name]
        shown = {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in r.items()}
        args = ", ".join(f"{k}={v!r}" for k, v in kw.items())
        print(f"[4c {name}] {fn}({args}, device='cuda'): {shown}")
        if not (r["ticks"] > 0 and r["launches"] == r["ticks"]):
            raise AssertionError(f"4c {name}: K1 launched {r['launches']} "
                                 f"times in {r['ticks']} ticks")
    tr, on, off = res["traverse"], res["wrench_on"], res["wrench_off"]
    if not (finite(tr) and tr["finite"] and tr["safe"]):
        raise AssertionError("4c traverse is not finite or not safe")
    if not finite(on):
        raise AssertionError("4c wrench_on is not finite")
    if not (finite(res["tracking"]) and res["tracking"]["safe"]):
        raise AssertionError("4c tracking is not finite or not safe")
    # the reference's 3.5 mm is not a gate at this depth: the JAX
    # package's own run of the call lands above it (PERF.md section 6)
    ok = _within_jax("traverse", "ee_pos_err_max_mm",
                     tr["ee_pos_err_max_mm"])
    ok &= _within_jax("traverse", "ee_ori_err_max_deg",
                      tr["ee_ori_err_max_deg"])
    ok &= tr["ee_ori_err_max_deg"] <= 2.6
    esc = tr["escape"]
    print(f"[4c escape] escaped {esc['escaped']}, deep solves' costs cold "
          f"{esc['cold_cost']:.6f} / warm {esc['warm_cost']:.6f}, K1 "
          f"launches {esc['launches']}, {esc['wall_s']:.1f} s")
    ok &= (math.isfinite(esc["cold_cost"]) and math.isfinite(esc["warm_cost"])
           and esc["launches"] == 0)
    ok &= _within_jax("tracking", "ee_pos_err_max_mm",
                      res["tracking"]["ee_pos_err_max_mm"])
    # OFF may collapse to non-finite values under the load (the JAX
    # package's longer runs do); a non-finite excursion is unbounded
    off_exc = off["ee_excursion_max_mm"]
    off_exc = off_exc if math.isfinite(off_exc) else math.inf
    jax_off = JAX_EXPERIMENTS["wrench_off"]["ee_excursion_max_mm"][0]
    print(f"[4c wrench] excursion ON {on['ee_excursion_max_mm']:.3f} mm "
          f"(bound 120), OFF {off['ee_excursion_max_mm']:.3f} mm (the JAX "
          f"run's {jax_off:.3f} mm); recovered ON {on['recovered']} (JAX "
          f"{JAX_EXPERIMENTS['wrench_on']['recovered']}), OFF "
          f"{off['recovered']}")
    ok &= (on["ee_excursion_max_mm"] < off_exc
           and on["ee_excursion_max_mm"] <= 120.0
           and on["recovered"] == JAX_EXPERIMENTS["wrench_on"]["recovered"])
    ok &= _within_jax("wrench_on", "ee_excursion_max_mm",
                      on["ee_excursion_max_mm"])
    if not ok:
        raise AssertionError("phase 4c: an experiment misses its gate")
    return {name: r["launches"] for name, r in res.items()}


def _fleet_times(mesh, step, B=SCALE_TIMED_BATCH):
    """Phase 9's printed numbers for this rank: the sharded fleet step on
    bench.py's problem at B global scenarios (this rank's share), by
    bench.py's method (2 untimed steps, then 10 timed between
    barriers); the all-reduce of fleet_mean alone on this rank's costs
    (host clock around synchronizes, median of 20); the peak memory."""
    import torch
    import torch.distributed as dist
    from qm_control_tpu_torch.parallel.distributed import sharded_fleet_step
    from qm_control_tpu_torch.parallel.mesh import (fleet_mean, local_rows,
                                                    mesh_device,
                                                    shard_scenarios)
    dev = mesh_device(mesh)
    fleet = sharded_fleet_step(mesh, step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batch = shard_scenarios(mesh, _bench_batch(B, dev))
    for _ in range(2):
        batch, pol, _ = fleet(batch)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(10):
        batch, pol, _ = fleet(batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 10
    dist.barrier()
    cost = local_rows(mesh, pol.cost)
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet_mean(mesh, cost)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return dict(B=B, ranks=mesh.size(), threads=torch.get_num_threads(),
                local_B=int(cost.shape[0]), step_ms=1e3 * step_s,
                allreduce_ms=statistics.median(times),
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _wbc_against_plain(model, info, args, x_k, tau_k):
    """K1's solution x_k (torques tau_k) of the batched WBC on `args` (its
    arguments) against vmap(cascade_plain) on the same stacks (wbc_stack,
    default gains), by phase 3b's rule: in each group of stacks (all four
    feet in contact: the stance case; else the trot case) the median
    torque gap within STACK_CASES' cold bound, and at each level the mean
    residual of K1 within 1.05 x the plain one's + 0.005 (1 + |b|).
    Returns (the plain torques, the numbers, whether the rule holds)."""
    import torch
    from torch.func import vmap
    from qm_control_tpu_torch.config import WbcGains
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.wbc.tasks import recover_torques
    from qm_control_tpu_torch.wbc.wbc import wbc_stack
    tau_max = torch.as_tensor(model.joint_effort, dtype=torch.float32,
                              device=x_k.device)
    m, tasks = vmap(lambda *a: wbc_stack(model, info, WbcGains(), tau_max,
                                         *a),
                    in_dims=(0,) * 6 + (None, None))(*args)
    x_p = vmap(K.cascade_plain)(*tasks)
    tau_p = vmap(recover_torques)(m, x_p)
    out = _torque_gap(tau_k, tau_p, args[5])
    ok = all(g["median"] < g["bound"] for g in out.values())
    means = []
    for t in tasks:
        r_k = (torch.einsum("bij,bj->bi", t.A, x_k) - t.b).norm(dim=1)
        r_p = (torch.einsum("bij,bj->bi", t.A, x_p) - t.b).norm(dim=1)
        means.append([float(r_k.mean()), float(r_p.mean()),
                      float((0.005 * (1 + t.b.norm(dim=1))).mean())])
    out["level_means"] = means
    return tau_p, out, ok and all(mk <= 1.05 * mp + sl
                                  for mk, mp, sl in means)


def _torque_gap(tau, ref, flags):
    """max over joints of |tau - ref| per scenario, in the groups of
    _wbc_against_plain: its quantiles, the bound of the group and the
    scenario of the largest gap."""
    import numpy as np
    gap = (tau - ref).abs().amax(dim=1).cpu().numpy()
    stance = flags.bool().all(dim=1).cpu().numpy()
    out = {}
    for (name, _, _, tols), sel in zip(STACK_CASES, (stance, ~stance)):
        if sel.any():
            q = np.percentile(gap[sel], [50, 99, 100])
            out[name] = dict(n=int(sel.sum()), median=float(q[0]),
                             p99=float(q[1]), max=float(q[2]),
                             bound=tols[0],
                             worst=int(np.flatnonzero(sel)[
                                 gap[sel].argmax()]))
    return out


def _gap_text(gap):
    return "; ".join(
        f"{name} ({g['n']}): median {g['median']:.4f} Nm (bound "
        f"{g['bound']}), p99 {g['p99']:.4f}, max {g['max']:.4f} (scenario "
        f"{g['worst']})" for name, g in gap.items() if name != "level_means")


def _digest(*tensors):
    """sha256 of the tensors' bytes: two runs' rows, the same bit for bit."""
    import hashlib
    h = hashlib.sha256()
    for a in tensors:
        h.update(a.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dryrun_check(mesh, model, info, cfg, batch, tag):
    """The sharded dry-run cycle (parallel.distributed.sharded_dryrun_cycle)
    on `batch` with K1's counts reset before and read after: one launch
    of B_local blocks, every torque finite and within model.joint_effort
    + 1e-3 (tests/test_hw.py's bound), and K1 against vmap(cascade_plain)
    on this rank's own stacks (_wbc_against_plain). Returns (its numbers,
    this rank's K1 torques, the plain ones)."""
    import numpy as np
    import torch
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.parallel.distributed import (
        dryrun_wbc_args, sharded_dryrun_cycle)
    from qm_control_tpu_torch.parallel.mesh import local_rows
    cycle = sharded_dryrun_cycle(mesh, model, info, cfg)
    torch.cuda.synchronize()
    K.launch_count = K.block_count = 0
    new_batch, policy, mean_cost, res = cycle(batch)
    launches, blocks = K.launch_count, K.block_count
    x_k, tau_k = local_rows(mesh, (res.x_opt, res.torques))
    args = dryrun_wbc_args(*local_rows(mesh, (policy, new_batch.x)))
    tau_p, vs_plain, plain_ok = _wbc_against_plain(model, info, args, x_k,
                                                   tau_k)
    tau = tau_k.cpu().numpy()
    finite = bool(np.isfinite(tau).all())
    over = float((np.abs(tau) - np.asarray(model.joint_effort)).max())
    print(f"[9 {tag}] sharded dry-run cycle: K1 launches {launches}, blocks "
          f"{blocks}; torques finite {finite}, max |tau| - effort "
          f"{over:.3e} Nm (bound 1e-3), mean MPC cost {float(mean_cost):.4f}"
          f"; K1 vs vmap(cascade_plain) on the same stacks: "
          f"{_gap_text(vs_plain)}; level residual means K1/plain/slack "
          f"{[[round(v, 4) for v in m] for m in vs_plain['level_means']]} "
          f"(bound 1.05x + slack)")
    if not ((launches, blocks) == (1, tau.shape[0]) and finite
            and over <= 1e-3 and plain_ok):
        raise AssertionError(f"phase 9 {tag}: the dry-run cycle launched K1 "
                             f"{launches} times ({blocks} blocks) for "
                             f"{tau.shape[0]} scenarios, or its torques are "
                             f"not finite and within the limits, or K1 "
                             f"misses vmap(cascade_plain)'s rule")
    return (dict(launches=launches, blocks=blocks, tau_over_effort=over,
                 vs_plain=vs_plain), tau_k, tau_p)


def _against_one_rank(model, info, step, full, rows):
    """Rank 0 of phase 9(b)/(c): the one-rank run on the global batch
    `full` (the unsharded step and the dry run's WBC, which phase 9(a)
    holds bit for bit the one-rank mesh's; its digest shows the parent
    that they are (a)'s rows) against the gathered rows of both ranks
    (cost, X, W, K1 torques, plain torques): phase 6's numbers for the
    rows, and per scenario the torque gap of K1 to K1 and of the plain
    version to the plain version."""
    from qm_control_tpu_torch.parallel import make_batched_wbc
    from qm_control_tpu_torch.parallel.distributed import dryrun_wbc_args
    ref_b, ref = step(full)
    args = dryrun_wbc_args(ref, ref_b.x)
    res = make_batched_wbc(model, info, cascade="fused",
                           device=full.x.device)(*args)
    ref_tau_p, _, _ = _wbc_against_plain(model, info, args, res.x_opt,
                                         res.torques)
    cost, X, W, tau_k, tau_p = rows
    return dict(
        digest=_digest(ref.cost, ref.X, ref.W, res.torques),
        cost_rel=float(((cost - ref.cost).abs()
                        / ref.cost.abs().clamp(min=1.0)).max()),
        x_err=float((X - ref.X).abs().max()),
        w_err=float((W - ref.W).abs().max()),
        k1=_torque_gap(tau_k, res.torques, args[5]),
        plain=_torque_gap(tau_p, ref_tau_p, args[5]))


def scaleout_rank():
    """Phase 9(b)/(c), one rank, run as `python -m torch.distributed.run
    --nproc-per-node 2 ... chip_smoke.py --scaleout-rank` with
    SCALEOUT_BACKEND, SCALEOUT_MODE and, for ranks that share a card,
    SCALEOUT_CARD in the environment; initialize_distributed reads the
    rest from torchrun's variables. MODE "check": the sharded fleet step
    on bench.py's problem at BATCH global scenarios, the dry-run cycle
    (_dryrun_check), the rows of both ranks gathered (mesh.gather_rows)
    and on rank 0 held against the one-rank run (_against_one_rank), one
    warm sharded batched cycle (make_batched_cycle on shard_scenarios
    carries, one K1 launch of B_local blocks per tick, every metric
    finite, every scenario safe); MODE "times": _fleet_times. Rank 0
    prints one JSON line with the numbers of every rank."""
    import torch
    import torch.distributed as dist
    from torch.func import vmap
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.experiments import _default_cfg
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.models import centroidal as C
    from qm_control_tpu_torch.models import default_q, load_model
    from qm_control_tpu_torch.parallel import (make_batched_cycle,
                                               make_batched_mpc_step)
    from qm_control_tpu_torch.parallel.distributed import (
        global_mesh, initialize_distributed, sharded_fleet_step)
    from qm_control_tpu_torch.parallel.mesh import (from_local_rows,
                                                    gather_rows, local_rows,
                                                    mesh_device,
                                                    shard_scenarios)
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    backend, mode = os.environ["SCALEOUT_BACKEND"], os.environ["SCALEOUT_MODE"]
    card = os.environ.get("SCALEOUT_CARD")
    K.build()                      # the parent built it: found on disk
    initialize_distributed(local_device_ids=None if card is None else
                           int(card), backend=backend)
    mesh = global_mesh()
    dev = mesh_device(mesh)
    rank = dist.get_rank()
    tag = f"{'b' if backend == 'gloo' else 'c'} rank {rank}"
    print(f"[9 {tag}] {dist.get_backend()} world {dist.get_world_size()} on "
          f"{dev} ({torch.cuda.get_device_name(dev)}), "
          f"{torch.get_num_threads()} intra-op threads")
    model = load_model()
    info = C.make_centroidal_info(model)
    cfg = QmConfig()
    step = make_batched_mpc_step(model, info, cfg)
    out = dict(rank=rank, backend=backend, card=dev.index)
    if mode == "times":
        out["times"] = _fleet_times(mesh, step)
    else:
        full = _bench_batch(BATCH, dev)
        batch = shard_scenarios(mesh, full)
        _, pol, mean_cost = sharded_fleet_step(mesh, step)(batch)
        dry, tau_k, tau_p = _dryrun_check(mesh, model, info, cfg, batch, tag)
        rows = gather_rows(mesh, (pol.cost, pol.X, pol.W,
                                  *from_local_rows(mesh, (tau_k, tau_p))))
        n = tau_k.shape[0]
        gathered = bool(torch.equal(rows[0][rank * n:(rank + 1) * n],
                                    pol.cost.to_local()))
        print(f"[9 {tag}] fleet step: {n} of {rows[0].shape[0]} scenarios, "
              f"mean cost {float(mean_cost):.6f}; the global gather "
              f"(gather_rows) holds this rank's rows: {gathered}")
        if not gathered:
            raise AssertionError(f"phase 9 {tag}: the gathered costs differ "
                                 f"from this rank's")
        if rank == 0:
            out["vs_one_rank"] = _against_one_rank(model, info, step, full,
                                                   rows)
        # one warm sharded batched cycle (phase 7's configuration)
        ccfg = _default_cfg()
        loop_cfg = LoopConfig(control_freq=1000.0)
        vcycle, make_carries = make_batched_cycle(model, info, ccfg, loop_cfg,
                                                  device=dev)
        loop = ControlLoop(model, info, ccfg, loop_cfg, device=dev)
        carries = make_carries(default_q(base_pos=(0, 0, 0.38)), BATCH)
        q = carries.plant.q.clone()
        q[:, 2] += torch.as_tensor(_spread(BATCH), device=dev)
        carries = carries._replace(plant=carries.plant._replace(q=q))
        carries, target, ms = local_rows(mesh, shard_scenarios(
            mesh, (carries, full.target, full.ms)))
        carries = vmap(loop._warmup)(carries, target, ms)     # one solve
        torch.cuda.synchronize()
        K.launch_count = K.block_count = 0
        t0 = time.perf_counter()
        carries, m = vcycle(carries, target, ms, ccfg.wbc)
        torch.cuda.synchronize()
        cycle_s = time.perf_counter() - t0
        launches, blocks = K.launch_count, K.block_count
        ticks = loop_cfg.ticks_per_cycle
        finite = all(bool(torch.isfinite(v).all()) for v in m
                     if v.dtype.is_floating_point)
        safe = bool(m.safe.all())
        print(f"[9 {tag}] warm sharded batched cycle, {n} carries: K1 "
              f"launches {launches}, blocks {blocks} in {ticks} ticks; every "
              f"metric finite {finite}, every scenario safe {safe}; "
              f"{cycle_s:.2f} s")
        if not ((launches, blocks) == (ticks, ticks * n) and finite and safe):
            raise AssertionError(f"phase 9 {tag}: the sharded batched cycle")
        out.update(mean_cost=float(mean_cost), dryrun=dry,
                   cycle=dict(launches=launches, blocks=blocks, ticks=ticks,
                              wall_s=cycle_s))
    sys.stdout.flush()
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, out)  # after every print of every rank
    dist.destroy_process_group()
    if rank == 0:                       # one write: no rank prints beside
        os.write(1, (json.dumps({"scaleout": ranks}) + "\n").encode())
    return 0


def _two_ranks(backend, mode, share_card, threads=None):
    """Two scaleout_rank processes in `mode` under torch.distributed.run on
    localhost (both on card 0 where `share_card`, else one card each by
    LOCAL_RANK; `threads`: their OMP_NUM_THREADS, torchrun's 1 when None),
    with a time limit; returns (their JSON results by rank, wall s)."""
    import signal
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "OMP_NUM_THREADS")}
    # the ranks share this host: sockets on the loopback interface
    env.update(SCALEOUT_BACKEND=backend, SCALEOUT_MODE=mode,
               GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
               PYTHONFAULTHANDLER="1")
    if share_card:
        env["SCALEOUT_CARD"] = "0"
    if threads:
        env["OMP_NUM_THREADS"] = str(threads)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port", str(port),
         os.path.abspath(__file__), "--scaleout-rank"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        log = proc.communicate(timeout=SCALE_CHILD_TIMEOUT_S)[0]
    finally:            # torchrun and its ranks, on a timeout too
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    results = []
    for line in log.splitlines():
        if line.startswith('{"scaleout"'):
            results = json.loads(line)["scaleout"]
        else:
            print(f"[9 torchrun] {line}")
    if proc.returncode != 0 or [r["rank"] for r in results] != [0, 1]:
        raise AssertionError(f"phase 9 {backend} {mode}: torchrun exit "
                             f"{proc.returncode}, results of ranks "
                             f"{[r['rank'] for r in results]}")
    return results, time.perf_counter() - t0


def _two_ranks_check(backend, share_card, a_out):
    """Phase 9(b)/(c) gates from the parent: every rank's K1 launches (the
    dry run one of B_local blocks, the warm cycle one per tick); rank 0's
    one-rank run the same bit for bit as (a)'s (the digest); the rows of
    both ranks against it by phase 6's batched-vs-unbatched rule (cost
    1e-3 relative, X 2e-3, W 0.5 N) and the dry run's K1 torques against
    its K1 torques by phase 3b's median rule (_torque_gap; the plain
    version's gap beside it, printed); mean_cost the same on both ranks
    and within 1e-5 relative of (a)'s."""
    results, wall = _two_ranks(backend, "check", share_card)
    n = BATCH // 2
    for res in results:
        dry, cyc = res["dryrun"], res["cycle"]
        if not ((dry["launches"], dry["blocks"]) == (1, n)
                and (cyc["launches"], cyc["blocks"])
                == (cyc["ticks"], cyc["ticks"] * n)):
            raise AssertionError(f"phase 9 {backend} rank {res['rank']}: K1 "
                                 f"launches {dry} / {cyc}")
    v = results[0]["vs_one_rank"]
    means = [res["mean_cost"] for res in results]
    rel = abs(means[0] - a_out["mean"]) / abs(a_out["mean"])
    same = v["digest"] == a_out["digest"]
    print(f"[9 {backend}] two ranks ({n} scenarios each, "
          f"{'sharing card 0' if share_card else 'one card each'}) against "
          f"the one-rank run (rank 0's recomputation bit for bit (a)'s: "
          f"{same}): cost {v['cost_rel']:.2e} rel (bound 1e-3), max|dX| "
          f"{v['x_err']:.2e} (2e-3), max|dW| {v['w_err']:.2e} (0.5); dry-run "
          f"torques, K1 against K1: {_gap_text(v['k1'])}; the plain version "
          f"against the plain version on the same inputs: "
          f"{_gap_text(v['plain'])}; mean_cost {means[0]:.6f} / "
          f"{means[1]:.6f} on the two ranks, {rel:.2e} rel of the one-rank "
          f"run's (1e-5); {wall:.1f} s wall")
    if not (same and v["cost_rel"] <= 1e-3 and v["x_err"] <= 2e-3
            and v["w_err"] <= 0.5 and means[0] == means[1] and rel <= 1e-5
            and all(g["median"] < g["bound"] for g in v["k1"].values())):
        raise AssertionError(f"phase 9 {backend}: the two ranks disagree "
                             f"with the one-rank run")
    return dict(share_card=share_card, vs_one_rank=v, mean_rel=rel,
                wall_s=wall, ranks=results)


def _k1_second_card(model, info):
    """K1 on card 1 after card 0 in one process (its shared-memory
    attribute is set per device): the stance stack, bit for bit."""
    import torch
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    _, tasks = _wbc_test_stack(model, info, torch.device("cuda", 0),
                               (1., 1., 1., 1.), 0.0)
    x0 = K.fused_hoqp(*tasks)
    x1 = K.fused_hoqp(*[type(t)(*[a.to("cuda:1") for a in t])
                        for t in tasks])
    same = bool(torch.equal(x0.cpu(), x1.cpu()))
    print(f"[9 c] K1 on cuda:1 after cuda:0 in one process: launched, "
          f"bit for bit the same {same}")
    if not same:
        raise AssertionError("phase 9 c: K1 on the second card differs")
    return same


def scaleout_check(model, info):
    """Phase 9's gates: (a) one rank over NCCL in this process; (b) two
    ranks on one card over gloo; (c) two ranks over NCCL, one card each,
    and K1 on the second card in this process, where the machine has two
    cards. Returns their numbers and the K1 launches of each path."""
    import torch
    import torch.distributed as dist
    from torch.utils._pytree import tree_leaves
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.parallel import make_batched_mpc_step, make_mesh
    from qm_control_tpu_torch.parallel.distributed import (
        sharded_fleet_step, sharded_mean, sharded_mpc_step)
    dev = torch.device("cuda")
    # ---- (a) one rank, NCCL, in this process ----
    mesh = make_mesh(device="cuda")
    backend = dist.get_backend()
    cfg = QmConfig()
    step = make_batched_mpc_step(model, info, cfg)
    batch = _bench_batch(BATCH, dev)
    ref_b, ref = step(batch)
    again = step(batch)[1]
    repeats = all(torch.equal(a, b) for a, b in zip(ref, again))
    ref_mean = float(ref.cost.mean())
    a_out = dict(backend=backend, unsharded_repeats=repeats)
    for name, wrap in (("sharded_fleet_step", sharded_fleet_step),
                       ("sharded_mpc_step", sharded_mpc_step)):
        nb, pol, mean_cost = wrap(mesh, step)(batch)
        exact = all(torch.equal(a.full_tensor(), b) for a, b in zip(
            tree_leaves((nb, pol)), tree_leaves((ref_b, ref))))
        rel = abs(float(mean_cost) - ref_mean) / abs(ref_mean)
        print(f"[9 a] {name} on a one-rank {backend} mesh, B = {BATCH}: "
              f"bit for bit the unsharded make_batched_mpc_step {exact} "
              f"(the unsharded step repeats bit for bit: {repeats}); "
              f"mean_cost {float(mean_cost):.6f} vs policy.cost.mean() "
              f"{ref_mean:.6f}: {rel:.2e} rel (bound 1e-5)")
        if not (backend == "nccl" and exact and rel <= 1e-5):
            raise AssertionError(f"phase 9 a: {name} on one rank")
        a_out[name] = dict(exact=exact, mean_rel=rel)
    a_out["dryrun"], tau_a, _ = _dryrun_check(mesh, model, info, cfg, batch,
                                              "a")
    a_out.update(mean=ref_mean, digest=_digest(ref.cost, ref.X, ref.W, tau_a))
    n = mesh.size()
    val = float(sharded_mean(mesh, lambda x: x)(
        torch.arange(2 * n, dtype=torch.float32, device=dev)))
    print(f"[9 a] sharded_mean over arange({2 * n}): {val} (closed form "
          f"{(2 * n - 1) / 2.0}, bound 1e-5)")
    if not abs(val - (2 * n - 1) / 2.0) <= 1e-5:
        raise AssertionError("phase 9 a: sharded_mean")
    dist.destroy_process_group()
    # ---- (b) two ranks on one card, gloo, CUDA tensors ----
    b_out = _two_ranks_check("gloo", True, a_out)
    # ---- (c) two ranks over NCCL, one card each ----
    cards = torch.cuda.device_count()
    if cards >= 2:
        c_out = _two_ranks_check("nccl", False, a_out)
        c_out["k1_second_card"] = _k1_second_card(model, info)
    else:
        c_out = f"not run: this machine has {cards} CUDA device(s)"
        print(f"[9 c] two NCCL ranks, one card each: {c_out}; NCCL "
              f"across cards and K1's per-device shared-memory setup stay "
              f"unverified")
    launches = {"9a dry run (1 rank)": a_out["dryrun"]["launches"],
                **{f"9b dry run, rank {r}": res["dryrun"]["launches"]
                   for r, res in enumerate(b_out["ranks"])},
                **{f"9b warm batched cycle, rank {r}":
                   res["cycle"]["launches"]
                   for r, res in enumerate(b_out["ranks"])}}
    return dict(one_rank=a_out, two_ranks_one_card=b_out, two_cards=c_out,
                launches=launches)


def scaleout_times(model, info, thread_sweep=False):
    """Phase 9's printed numbers, with no other child running: the sharded
    fleet step on one rank (NCCL, this process) at SCALE_TIMED_BATCH and
    at half of it, then on two ranks sharing the card (gloo, torchrun) at
    SCALE_TIMED_BATCH global with half this host's cores as each rank's
    OMP_NUM_THREADS (so the two oversubscribe no core); with
    `thread_sweep`, once more with all the cores each, as many intra-op
    threads as one rank alone has. Solves/s, the all-reduce's ms, peak
    memory per rank."""
    import torch.distributed as dist
    from qm_control_tpu_torch.config import QmConfig
    from qm_control_tpu_torch.parallel import make_batched_mpc_step, make_mesh
    mesh = make_mesh(device="cuda")
    backend = dist.get_backend()
    step = make_batched_mpc_step(model, info, QmConfig())
    one = _fleet_times(mesh, step)
    half = _fleet_times(mesh, step, SCALE_TIMED_BATCH // 2)
    dist.destroy_process_group()
    print(f"[9 times] sharded fleet step (2 untimed, 10 timed), one rank "
          f"({backend}, {one['threads']} threads): B = {SCALE_TIMED_BATCH} "
          f"{one['step_ms']:.1f} ms, "
          f"{1e3 * SCALE_TIMED_BATCH / one['step_ms']:.1f} solves/s, peak "
          f"{one['peak_gib']:.2f} GiB, all-reduce {one['allreduce_ms']:.3f} "
          f"ms; B = {half['B']} {half['step_ms']:.1f} ms")
    cores = len(os.sched_getaffinity(0))
    out = dict(one_rank=one, one_rank_half=half, cores=cores,
               solves_per_s=1e3 * SCALE_TIMED_BATCH / one["step_ms"])
    for key, threads in (("two_ranks", max(1, cores // 2)),
                         ("two_ranks_all_threads", cores)):
        if key == "two_ranks_all_threads" and not thread_sweep:
            break
        results, _ = _two_ranks("gloo", "times", True, threads)
        two = [r["times"] for r in results]
        two_ms = max(t["step_ms"] for t in two)
        out[key] = dict(ranks=two, solves_per_s=1e3 * SCALE_TIMED_BATCH
                        / two_ms, speedup=one["step_ms"] / two_ms)
        print(f"[9 times] two ranks sharing the card (gloo, {threads} "
              f"threads each) at B = {SCALE_TIMED_BATCH} global: "
              + ", ".join(f"rank {r} {t['step_ms']:.1f} ms, peak "
                          f"{t['peak_gib']:.2f} GiB, all-reduce "
                          f"{t['allreduce_ms']:.3f} ms"
                          for r, t in enumerate(two))
              + f": {out[key]['solves_per_s']:.1f} solves/s, "
              f"{out[key]['speedup']:.2f}x one rank")
    return out


def distributed_only():
    """`chip_smoke.py --distributed`: phases 1-2 (the card, K1's build)
    and phase 9 alone."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.models import centroidal as C
    from qm_control_tpu_torch.models import load_model
    clock = _Clock()
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} count "
          f"{torch.cuda.device_count()}")
    K.build()
    print(f"[build] K1 in {K.build_info['seconds']:.1f} s; dynamic shared "
          f"memory per block {K.smem_bytes()} B")
    clock.done("1-2")
    model = load_model()
    info = C.make_centroidal_info(model)
    scale = scaleout_check(model, info)
    clock.done("9 (checks)")
    scale["times"] = scaleout_times(model, info, thread_sweep=True)
    clock.done("9 (times)")
    print(json.dumps({"scaleout": scale, "card": smi}))
    print(smi)
    return 0


class _Clock:
    """Prints each phase's wall time."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name):
        now = time.perf_counter()
        print(f"[wall] phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch.kernels import hoqp_fused as K

    clock = _Clock()
    # ---- 1. the card -------------------------------------------------
    smi = _smi()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; host CPU cores "
          f"{os.cpu_count()}")

    # ---- 2. build K1 -------------------------------------------------
    path = K.build()
    print(f"[build] {os.path.basename(path)} in "
          f"{K.build_info['seconds']:.1f} s (nvcc sm_90a)")
    for line in K.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print("[build] " + line.strip())
    print(f"[build] dynamic shared memory per block: {K.smem_bytes()} B")
    from qm_control_tpu_torch import native
    t0 = time.perf_counter()
    path = native.build()
    native.load()
    print(f"[build] {os.path.relpath(path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s (g++, the port's copy of "
          f"qm_native.cpp)")
    clock.done("1-2")

    # ---- 4b, 4c, 4d and 4g run in child processes beside phases 3-4f -----
    # (the host is the bottleneck of every one of them); two 4c children
    # at a time on a host with few cores
    cores = os.cpu_count() or 1
    jobs = [("4b", ["--main-path"]), ("4d", ["--mpc-variant"]),
            ("4g", ["--hardware"])] + [
        (f"4c-{n}", ["--experiment", n]) for n in EXPERIMENTS]
    width = len(jobs) if cores >= 8 else 3
    print(f"[host] {cores} CPU cores: {len(jobs)} child processes, "
          f"{width} at a time")
    children = _Children(jobs, width)
    try:
        return _phases(smi, clock, children)
    finally:
        children.stop()


def _phases(smi, clock, children):
    """Phases 3-5 and the batch path; phases 4b and 4c are `children`,
    read after phase 4a."""
    import numpy as np
    import torch

    from qm_control_tpu_torch.kernels import hoqp_fused as K
    from qm_control_tpu_torch.models import centroidal as C
    from qm_control_tpu_torch.models import default_q, load_model
    from qm_control_tpu_torch.runtime import plant as P
    from qm_control_tpu_torch.runtime.estimator import rbd_state_from_plant
    from qm_control_tpu_torch.runtime.loop import ControlLoop, LoopConfig
    from qm_control_tpu_torch.wbc import tasks as T
    from qm_control_tpu_torch.wbc.wbc import wbc_stack

    dev = torch.device("cuda")
    # ---- 3. K1 against its plain version on the card ------------------
    def to_tasks(stack):
        return [T.Task(*[torch.as_tensor(a, device=dev) for a in t])
                for t in stack]

    gen = torch.Generator().manual_seed(0)

    def dusted(stack):
        """`stack` with 1e-7 relative noise on every entry (f32 last bits):
        how far it moves the optimum is the spread of any f32 solver."""
        return [T.Task(*[a * (1.0 + 1e-7 * torch.randn(
            a.shape, generator=gen).to(dev)) for a in t]) for t in stack]

    # random cascades, as drawn: level 0 is infeasible and its 10-iteration
    # IP ends short of feasibility, so the lower levels are degenerate and
    # two correct f32 implementations end far apart in x. K1 is held
    # lexicographically: the same level-0 residual, and at the first lower
    # level where the two differ by more than the bound of the repo's own
    # two-implementation test (0.2 max(|o|, 1) + 0.6,
    # test_cascade_exact_matches_padded_objectives) K1 must be the better.
    # With the bounds loosened by 10 (feasible, well-posed): x itself,
    # within 1e-3 (1 + |x|inf); beside it, how far 1e-7 input dust moves
    # the plain version on the card.
    dust_rel = 0.0
    for seed in range(16):
        stack = _random_cascade(np.random.default_rng(seed))
        for shifted in (False, True):
            if shifted:
                stack[0] = stack[0][:3] + (stack[0][3] + 10.0,)
            ts = to_tasks(stack)
            xk, xp = K.fused_hoqp(*ts), K.cascade_plain(*ts)
            ok = bool(torch.isfinite(xk).all())
            if shifted:
                scale = 1.0 + float(xp.abs().max())
                err = float((xk - xp).abs().max())
                ok &= err <= 1e-3 * scale
                dust = float((K.cascade_plain(*dusted(ts)) - xp).abs().max())
                dust_rel = max(dust_rel, dust / scale)
                print(f"[k1 random {seed:2d} feasible] max|x_k - x_p| "
                      f"{err:.3e} ({err / scale:.2e} of 1 + |x|), plain "
                      f"under dust {dust:.3e}")
            else:
                ok &= _lexicographic_ok(ts, xk, xp)
                print(f"[k1 random {seed:2d} as drawn] level residuals "
                      f"kernel {[round(float(v), 4) for v in _levels(ts, xk)]}"
                      f" plain {[round(float(v), 4) for v in _levels(ts, xp)]}")
            if not ok:
                raise AssertionError(f"K1 disagrees with plain on random "
                                     f"{seed} (feasible={shifted})")
    print(f"[k1 random feasible] the plain version under 1e-7 dust moves up "
          f"to {dust_rel:.2e} of 1 + |x|")

    model = load_model()
    info = C.make_centroidal_info(model)
    real = {name: (_wbc_test_stack(model, info, dev, flags, vq), tols)
            for name, flags, vq, tols in STACK_CASES}
    mpc_only = {f"mpc-only {name}": (_wbc_test_stack(
        model, info, dev, flags, vq, mpc_only=True), tols)
        for name, flags, vq, tols in STACK_CASES}
    worst_real = worst_mpc = 0.0
    for name, ((m_, st), tols) in [*real.items(), *mpc_only.items()]:
        nudged = [T.Task(*[a * (1.0 + 1e-3) for a in t]) for t in st]
        xk, wk = K.fused_hoqp(*st, return_warm=True)
        xp = K.cascade_plain(*st)
        xkw = K.fused_hoqp(*nudged, warm=wk)
        xpw = K.cascade_plain(*nudged, warm=wk)
        xk0 = K.fused_hoqp(*st, warm=K.zero_warm(56, device=dev))
        def tau(x):
            return T.recover_torques(m_, x.to(dev))
        xc = K.cascade_plain(*[T.Task(*[a.cpu() for a in t]) for t in st])
        moves = np.zeros((DUST_DRAWS, 3))
        for i in range(DUST_DRAWS):
            sd = dusted(st)
            xkd, xpd = K.fused_hoqp(*sd), K.cascade_plain(*sd)
            moves[i] = [float((tau(xkd) - tau(xk)).abs().max()),
                        float((tau(xpd) - tau(xp)).abs().max()),
                        float((tau(xkd) - tau(xpd)).abs().max())]
        print(f"[k1 {name} spread] max|dtau| Nm: plain on the CPU vs on the "
              f"card {float((tau(xc) - tau(xp)).abs().max()):.4f}; over "
              f"{DUST_DRAWS} draws of 1e-7 dust K1 moves up to "
              f"{moves[:, 0].max():.4f}, plain up to {moves[:, 1].max():.4f}"
              f"; K1 vs plain on the same dusted input: median "
              f"{float(np.median(moves[:, 2])):.4f}, max "
              f"{moves[:, 2].max():.4f}")
        # the MPC-only stance stack has two level-1 optima 0.6 apart in
        # residual, and f32 roundoff picks one (on the CPU one draw of
        # eight of 1e-7 dust moves the plain version there by 0.80 Nm), so
        # the MPC-only stacks are held to the JAX package's bound between
        # two implementations of the cascade (tests/test_kernels.py:
        # 1.0 Nm stance, 2.0 Nm trot) and lexicographically per level
        main = name in real
        for label, a, b, stack, tol in (("cold", xk, xp, st, tols[0]),
                                        ("warm", xkw, xpw, nudged, tols[1])):
            dtau = float((T.recover_torques(m_, a)
                          - T.recover_torques(m_, b)).abs().max())
            err = float((a - b).abs().max())
            if main:
                worst_real = max(worst_real, err)
            else:
                worst_mpc = max(worst_mpc, err)
                tol = max(tol, 1.0)
            print(f"[k1 {name} {label}] max|x_k - x_p| {err:.3e}, "
                  f"torques {dtau:.3e} Nm (bound {tol} Nm)")
            if not (bool(torch.isfinite(a).all()) and dtau < tol):
                raise AssertionError(f"K1 {name} {label} disagrees")
            if not main and not _lexicographic_ok(stack, a, b):
                raise AssertionError(f"K1 {name} {label} disagrees per "
                                     f"level: {_levels(stack, a)} vs plain "
                                     f"{_levels(stack, b)}")
            if main and name.endswith("trot"):
                for t in stack:
                    r_k = float((t.A @ a - t.b).norm())
                    r_p = float((t.A @ b - t.b).norm())
                    if not r_k < 1.25 * r_p + 0.005 * (1 + float(t.b.norm())):
                        raise AssertionError(f"K1 trot {label} residual "
                                             f"{r_k} vs plain {r_p}")
        if not torch.equal(xk0, xk):
            raise AssertionError(f"K1 {name}: warm with validity 0 != cold")
        print(f"[k1 {name}] warm with validity 0 equals cold bit for bit")
        # determinism: K1 holds one result per input (its warp-level
        # pivot search and reductions must not depend on scheduling)
        xk2, wk2 = K.fused_hoqp(*st, return_warm=True)
        xkw2 = K.fused_hoqp(*nudged, warm=wk)
        if not (torch.equal(xk2, xk) and torch.equal(wk2, wk)
                and torch.equal(xkw2, xkw)):
            raise AssertionError(f"K1 {name}: two launches on the same "
                                 f"inputs differ")
        print(f"[k1 {name}] two launches on the same inputs equal bit for "
              f"bit (cold x and warm_out, warm x)")

    torch.cuda.synchronize()
    clock.done("3")

    # ---- 3b. K1 with grid = B (its times follow phase 5) ----------------
    bt, worst_batched, plain_batched_ms = _k1_batched_check(real, dev)
    clock.done("3b")

    # ---- 4. the tick path, without an MPC stage ------------------------
    from qm_control_tpu_torch.experiments import _default_cfg
    cfg = _default_cfg()        # standing_ee_hold's: N = 67, 1 iteration
    loop_cfg = LoopConfig(control_freq=1000.0)
    q0 = default_q(base_pos=(0, 0, 0.38))
    loop = ControlLoop(model, info, cfg, loop_cfg, device="cuda")
    carry0 = loop.init_carry(q0)
    print(f"[ticks] hold policy N = {cfg.mpc.num_nodes} intervals, "
          f"ticks per MPC period {loop_cfg.ticks_per_cycle}")
    ee0 = rbd_state_from_plant(model, carry0.plant.q, carry0.plant.v)[48:51]
    torch.cuda.synchronize()
    K.launch_count = 0
    t_start = time.perf_counter()
    carry, out = loop.run_ticks(carry0, TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = K.launch_count
    ee = rbd_state_from_plant(model, carry.plant.q, carry.plant.v)[48:51]
    dz = float((out.q[:, 2] - 0.38).abs().max())
    drift = float((ee - ee0).norm())
    safe = bool(out.safe.all())
    print(f"[ticks] {TICKS} ticks in {wall:.2f} s wall "
          f"({1e3 * wall / TICKS:.2f} ms/tick incl. first use), "
          f"K1 launches {launches}, safe {safe}, max|z - 0.38| {dz:.4f} m, "
          f"EE drift {1e3 * drift:.2f} mm")
    if launches != TICKS:
        raise AssertionError(f"K1 launched {launches} times in {TICKS} ticks")
    if not (bool(torch.isfinite(out.q).all())
            and bool(torch.isfinite(out.torques).all())):
        raise AssertionError("the tick path produced non-finite values")
    if not safe:
        raise AssertionError("the tick path left the safe set")
    # the CPU sanity test's bounds: base height within 1 cm, the EE within
    # 5 mm over 100 ticks of the hold policy
    if dz >= 0.01 or drift >= 0.005:
        raise AssertionError(f"standing hold drifted: dz {dz}, EE {drift}")
    # first 10 ticks against cascade_plain, called explicitly on the card;
    # the closed loop amplifies last-bit differences through the landing
    # transient, so the bound adds twice the plain loop's own spread
    plain_loop = ControlLoop(model, info, cfg, loop_cfg, device="cuda",
                             cascade=K.cascade_plain)
    _, ref = plain_loop.run_ticks(carry0, 10)
    rng = np.random.default_rng(7)
    band = np.zeros(2)
    for _ in range(2):
        qd = carry0.plant.q * (1.0 + 1e-7 * torch.as_tensor(
            rng.standard_normal(24), dtype=torch.float32, device=dev))
        _, o = plain_loop.run_ticks(carry0._replace(
            plant=carry0.plant._replace(q=qd)), 10)
        band = np.maximum(band, [float((o.q - ref.q).abs().max()),
                                 float((o.torques - ref.torques).abs().max())])
    gq = float((out.q[:10] - ref.q).abs().max())
    gt = float((out.torques[:10] - ref.torques).abs().max())
    print(f"[ticks] ticks 1-10 vs cascade_plain: max|dq| {gq:.3e} "
          f"(spread {band[0]:.3e}), max|dtau| {gt:.3e} Nm "
          f"(spread {band[1]:.3e})")
    if not (gq <= 2 * band[0] + 1e-4 and gt <= 2 * band[1] + 0.1):
        raise AssertionError("the tick path with K1 disagrees with the "
                             "plain cascade on the card")
    clock.done("4")

    # ---- 4a. the MPC on the card ----------------------------------------
    from qm_control_tpu_torch.config import MpcConfig, QmConfig
    from qm_control_tpu_torch.gaits.library import GAIT_LIBRARY, GaitSchedule
    from qm_control_tpu_torch.mpc.mpc import MpcSolver
    from qm_control_tpu_torch.ocp.problem import make_ocp
    from qm_control_tpu_torch.ocp.reference import target_from_knots
    from qm_control_tpu_torch.solver.sqp import SqpSettings
    # the golden scenario of tests/test_golden.py at that test's bounds
    gcfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.5, dt=0.025,
                                          num_iterations=3))
    xg, sg = _standing()
    pol = MpcSolver(model, info, gcfg, device="cuda").solve(
        0.0, torch.tensor(xg, device=dev),
        target_from_knots([0.0, 10.0], [sg, sg], device=dev),
        GaitSchedule(GAIT_LIBRARY["stance"]).mode_schedule(0.0, 10.0,
                                                           device=dev))
    with open(os.path.join(ROOT, "tests", "golden_standing.json")) as fh:
        golden = json.load(fh)
    U, X = pol.U.cpu().numpy(), pol.X.cpu().numpy()
    gaps = dict(
        cost=abs(float(pol.cost) - golden["cost"])
        / max(1.0, abs(golden["cost"])),
        x_mid=float(np.abs(X[10] - golden["x_mid"]).max()),
        u_first=float(np.abs(U[0] - golden["u_first"]).max()),
        u_mid=float(np.abs(U[10] - golden["u_mid"]).max()))
    fz = (U[:, 2] + U[:, 5] + U[:, 8] + U[:, 11])[:-1].mean()
    print(f"[mpc golden] cost {float(pol.cost):.6f} (golden "
          f"{golden['cost']:.6f}); gaps: cost {gaps['cost']:.2e} rel "
          f"(bound 1e-3), X[10] {gaps['x_mid']:.2e} (2e-3), U[0] "
          f"{gaps['u_first']:.2e} N (0.5), U[10] {gaps['u_mid']:.2e} N "
          f"(0.5); mean fz {fz:.2f} N vs m g "
          f"{model.total_mass * 9.81:.2f} N, final z {X[-1, 8]:.4f} m")
    if not (gaps["cost"] <= 1e-3 and gaps["x_mid"] <= 2e-3
            and gaps["u_first"] <= 0.5 and gaps["u_mid"] <= 0.5):
        raise AssertionError(f"the MPC on the card misses the golden "
                             f"solution: {gaps}")
    if not (abs(fz / (model.total_mass * 9.81) - 1.0) <= 0.05
            and 0.37 < X[-1, 8] < 0.41 and np.abs(U[:, 12:24]).max() < 2.0):
        raise AssertionError("the golden solution's invariants fail")
    # full width: cold + warm mpc_step on the card and on the CPU
    ocp = make_ocp(model, info, cfg)
    settings = SqpSettings(num_iterations=cfg.mpc.num_iterations)
    gpu = _solve_pair(ocp, model, info, cfg, dev, settings)
    cpu = _solve_pair(ocp, model, info, cfg, torch.device("cpu"), settings)
    for label, a, b in (("cold", gpu[0], cpu[0]), ("warm", gpu[1], cpu[1])):
        dc = abs(float(a.cost) - float(b.cost)) / max(1.0, abs(float(b.cost)))
        dx = float((a.X.cpu() - b.X).abs().max())
        dw = float((a.W.cpu() - b.W).abs().max())
        print(f"[mpc N={cfg.mpc.num_nodes} {label}] card vs CPU: cost "
              f"{float(a.cost):.6f} / {float(b.cost):.6f} ({dc:.2e} rel), "
              f"max|dX| {dx:.2e}, max|dW| {dw:.2e}; alpha "
              f"{float(a.alpha)} / {float(b.alpha)}")
        if not (dc <= 1e-3 and dx <= 2e-3 and dw <= 0.5
                and bool(torch.isfinite(a.X).all())):
            raise AssertionError(f"the {label} solve on the card disagrees "
                                 f"with the CPU")
    clock.done("4a")

    # ---- 4e. K1 on the MPC-only stack in make_mpc_cycle --------------------
    mpc_k1_launches, mpc_k1_ticks, _ = mpc_cycle_k1(model, info, dev, cfg)
    clock.done("4e")

    # ---- 4f. the pivoted cascade against K1 ---------------------------------
    pivot_launches = pivoted_vs_k1(model, info, dev, real, cfg, q0, dusted)
    hoqp_batched_ms, hoqp_graph = _batched_hoqp_check(model, info, dev, cfg)
    clock.done("4f")

    # ---- 9. scale-out, its gates (in the wait for the children) ------------
    scale_out = scaleout_check(model, info)
    clock.done("9 (checks)")

    # ---- 4b, 4c, 4d and 4g (the child processes) ---------------------------
    ended = children.join(timeout=CHILD_TIMEOUT_S)
    results = {}
    keys = {"4b": '{"main_path"', "4d": '{"mpc_variant"',
            "4g": '{"hardware"'}
    for name, (rc, lines, wall) in ended.items():
        key = keys.get(name, '{"experiment"')
        for line in lines:
            if not line.startswith(key):
                print(f"[{name} child] " + line)
        print(f"[wall] child {name}: {wall:.1f} s, exit {rc}")
        if rc != 0 or not lines or not lines[-1].startswith(key):
            raise AssertionError(f"phase {name} failed (exit {rc})")
        results[name] = json.loads(lines[-1])
    hold = results.pop("4b")["main_path"]
    variant = results.pop("4d")["mpc_variant"]
    _check_variant(variant)
    hw = results.pop("4g")["hardware"]    # gated in its child
    print(f"[main] standing_ee_hold({', '.join(f'{k}={v!r}' for k, v in HOLD.items())}"
          f", device='cuda'): {hold['wall_s']:.1f} s wall, K1 launches "
          f"{hold['launches']} in {HOLD_TICKS} ticks, safe {hold['safe']}, "
          f"finite {hold['finite']}; EE {hold['ee_pos_err_max_mm']:.3f} mm "
          f"/ {hold['ee_ori_err_max_deg']:.4f} deg (gates 3.5 mm / 2.6 deg; "
          f"the JAX package's run {JAX_HOLD['ee_pos_err_max_mm']:.3f} mm / "
          f"{JAX_HOLD['ee_ori_err_max_deg']:.4f} deg); plan "
          f"{hold['ee_plan_err_max_mm']:.3f} mm, execution "
          f"{hold['ee_exec_err_max_mm']:.3f} mm, roll p-p "
          f"{hold['roll_pp_deg']:.4f} deg; {hold['cycle_timer']}")
    if hold["launches"] != HOLD_TICKS:
        raise AssertionError(f"K1 launched {hold['launches']} times in "
                             f"{HOLD_TICKS} ticks of the main path")
    if not (hold["finite"] and hold["safe"]):
        raise AssertionError("the main path is not finite or not safe")
    for key, bound in HOLD_GATES.items():
        if not hold[key] <= bound:
            raise AssertionError(f"main path {key} {hold[key]} > {bound}")
    launches = hold["launches"]
    exp_launches = _check_experiments(
        {n[3:]: r["result"] for n, r in results.items()})
    exp_walls = {n: round(w, 1) for n, (_, _, w) in ended.items()}
    clock.done("4b-4d (wait)")

    # ---- 5. times ---------------------------------------------------------
    state = {"carry": carry}

    def period():
        state["carry"], _ = loop.run_ticks(state["carry"], 10)

    period()
    tick_ms = _cuda_ms(period, reps=9) / 10.0
    # the same tick by differential chaining (utils/profiling.py: chains
    # of 2 and 12 ticks, CUDA events, best of 2)
    from qm_control_tpu_torch.utils.profiling import chained_latency

    def one_tick(c):
        return loop.run_ticks(c, 1)[0]
    one_tick.init = lambda: state["carry"]
    chained_tick_ms = 1e3 * chained_latency(one_tick, k1=2, k2=12, reps=2)
    (_, st), _ = real["stance"]
    K.fused_hoqp(*st)
    k1_ms = _cuda_ms(lambda: K.fused_hoqp(*st), reps=9, inner=20)
    plain_ms = _cuda_ms(lambda: K.cascade_plain(*st), reps=3)
    ma0, nv = st[0].A.shape[0], st[0].D.shape[0]
    flops, nbytes = _k1_work(ma0, nv, st[1].A.shape[0], st[2].A.shape[0], 10)
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    # K1-warm: the same cascade from a warm iterate (the warm buffer of a
    # cold launch, inputs nudged 1e-3): the same iterations, so the same
    # operations, and the (9, W) warm buffer read besides
    _, wk = K.fused_hoqp(*st, return_warm=True)
    nudged_st = [T.Task(*[a * (1.0 + 1e-3) for a in t]) for t in st]
    K.fused_hoqp(*nudged_st, warm=wk)
    k1_warm_ms = _cuda_ms(lambda: K.fused_hoqp(*nudged_st, warm=wk), reps=9,
                          inner=20)
    t_wbytes = (nbytes + 4 * wk.numel()) / H100_BYTES_PER_S
    warm_bound_ms = 1e3 * max(t_ops, t_wbytes)
    print(f"[time] {tick_ms:.3f} ms per control tick (median of 9 MPC "
          f"periods of 10 ticks, K1 included; {chained_tick_ms:.3f} ms by "
          f"chained_latency), K1 {1e3 * k1_ms:.1f} us per "
          f"launch (median), plain cascade on the card {plain_ms:.1f} ms, "
          f"K1 launches per tick {launches / HOLD_TICKS:.0f}")
    print(f"[time] K1 work at shapes {ma0}/{nv}/{st[1].A.shape[0]}/"
          f"{st[2].A.shape[0]}: {flops / 1e6:.1f} MFLOP f32, "
          f"{nbytes} B -> bound {1e3 * bound_ms:.3f} us "
          f"({'operations' if t_ops >= t_bytes else 'bytes'}); "
          f"no single PyTorch call computes this cascade (library_ms null)")
    print(f"[time] K1-warm {1e3 * k1_warm_ms:.1f} us per launch (median), "
          f"beside K1-cold {1e3 * k1_ms:.1f} us; bound "
          f"{1e3 * warm_bound_ms:.3f} us "
          f"({'operations' if t_ops >= t_wbytes else 'bytes'}; the warm "
          f"buffer adds {4 * wk.numel()} B)")
    # K1 on the MPC-only variant's stack (30/56/18/12)
    (_, st_mpc), _ = mpc_only["mpc-only stance"]
    k1_mpc_ms = _cuda_ms(lambda: K.fused_hoqp(*st_mpc), reps=9, inner=20)
    mshape = (st_mpc[0].A.shape[0], st_mpc[0].D.shape[0],
              st_mpc[1].A.shape[0], st_mpc[2].A.shape[0])
    mflops, mbytes = _k1_work(*mshape, 10)
    m_ops, m_bytes = mflops / H100_F32_FLOPS, mbytes / H100_BYTES_PER_S
    mpc_bound_ms = 1e3 * max(m_ops, m_bytes)
    mpc_bound_by = "operations" if m_ops >= m_bytes else "bytes"
    print(f"[time] K1 on the MPC-only stack {'/'.join(map(str, mshape))}: "
          f"{1e3 * k1_mpc_ms:.1f} us per launch (median); work "
          f"{mflops / 1e6:.1f} MFLOP, {mbytes} B -> bound "
          f"{1e3 * mpc_bound_ms:.3f} us ({mpc_bound_by})")
    # the pivoted cascade (wbc/hoqp.py) per call, on the stance stack
    from qm_control_tpu_torch.wbc.hoqp import hoqp_solve
    hoqp_solve(st)
    hoqp_ms = _cuda_ms(lambda: hoqp_solve(st), reps=5)
    print(f"[time] the pivoted cascade hoqp_solve on the stance stack: "
          f"{hoqp_ms:.1f} ms per call (median of 5), K1 "
          f"{1e3 * k1_ms:.1f} us")
    # host wall time of the tick's layers, synchronized after each call
    # (before the profiler, which may leave tracing on)
    c = state["carry"]
    args = (model, info, loop.gains, loop.tau_max, c.policy.X[0, 0],
            c.policy.U[0, 0], c.input_last, c.plant.q, c.plant.v,
            torch.ones(4, device=dev), torch.tensor(0.001, device=dev), c.t)
    _, stack = wbc_stack(*args)
    step = P.make_plant_step(model, loop_cfg.plant)

    def host_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n
    layers = {"WBC data + tasks": lambda: wbc_stack(*args),
              "K1": lambda: K.fused_hoqp(*stack),
              "plant step": lambda: step(c.plant)}
    print("[layers] host ms per call, synchronized: " + ", ".join(
        f"{name} {host_ms(fn):.2f}" for name, fn in layers.items()))
    # the MPC solve, warm-started at full width; the cycle
    warm = gpu[2]
    warm()
    mpc_ms = _cuda_ms(warm, reps=9)
    lu = SqpSettings(num_iterations=cfg.mpc.num_iterations,
                     unrolled_ops=False)
    warm(lu)
    mpc_lu_ms = _cuda_ms(lambda: warm(lu), reps=1)
    target, ms = _hold_problem(dev)
    cyc = {"carry": loop.warmup(loop.init_carry(q0), target, ms, 1)}

    def cycle():
        cyc["carry"], _ = loop.run(cyc["carry"], target, ms, 1)
    cycle()
    cycle_ms = _cuda_ms(cycle, reps=3)
    print(f"[time] MPC solve at N = {cfg.mpc.num_nodes}, warm-started: "
          f"{mpc_ms:.1f} ms (median of 9, unrolled_ops=True), "
          f"{mpc_lu_ms:.1f} ms (once, unrolled_ops=False); "
          f"{cycle_ms:.1f} ms per MPC cycle (1 solve + "
          f"{loop_cfg.ticks_per_cycle} ticks, median of 3)")
    # the associative-scan Riccati beside the serial sweep, same warm solve
    par = SqpSettings(num_iterations=cfg.mpc.num_iterations,
                      parallel_riccati=True)
    sp, ss = warm(par), gpu[1]
    par_dc = abs(float(sp.cost) - float(ss.cost)) / (1.0 + abs(float(ss.cost)))
    par_dw = float((sp.W - ss.W).abs().max()) / (1.0 + float(ss.W.abs().max()))
    mpc_par_ms = _cuda_ms(lambda: warm(par), reps=5)
    print(f"[riccati] warm solve at N = {cfg.mpc.num_nodes} with "
          f"parallel_riccati=True: {mpc_par_ms:.1f} ms (median of 5) beside "
          f"the serial sweep's {mpc_ms:.1f} ms; vs the serial solve: cost "
          f"{float(sp.cost):.6f} / {float(ss.cost):.6f} ({par_dc:.2e} rel, "
          f"bound 1e-2), W {par_dw:.2e} of 1 + |W| (bound 5e-3), alpha "
          f"{float(sp.alpha)} / {float(ss.alpha)}")
    if not (par_dc <= 1e-2 and par_dw <= 5e-3
            and bool(torch.isfinite(sp.X).all())):
        raise AssertionError("the parallel Riccati solve disagrees with the "
                             "serial one")
    lq_rel = parallel_riccati_lq(dev)
    ilqr_err = ilqr_lqr(dev)
    # host syncs inside one cycle (its caches warm)
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cycle()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    flagged = [w for w in caught
               if "called a synchronizing CUDA operation" in str(w.message)]
    print(f"[sync] one cycle: {len(flagged)} synchronizing calls flagged"
          f" at {sorted({f'{w.filename}:{w.lineno}' for w in flagged})}")
    clock.done("5")

    # ---- 3b (times), 6, 7, 8: the batch path --------------------------------
    k1_times = _k1_batched_times(bt, (flops, nbytes))
    clock.done("3b (times)")
    mpc_b, mpc_b_step = batched_mpc(model, info, parallel=True)
    clock.done("6")
    b_launches, b_blocks, b_cycle_ms = batched_cycle(model, info, dev)
    clock.done("7")
    from qm_control_tpu_torch.experiments import batched_rollouts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    roll = batched_rollouts(cfg=_default_cfg(), batch=BATCH, num_steps=5,
                            seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"[rollouts] {roll['experiment']} at N = {cfg.mpc.num_nodes}, 5 "
          f"steps: {time.perf_counter() - t0:.1f} s wall, finite_fraction "
          f"{roll['finite_fraction']}, cost_mean {roll['cost_mean']:.4f}, "
          f"cost_p95 {roll['cost_p95']:.4f}")
    if roll["finite_fraction"] != 1.0:
        raise AssertionError("batched_rollouts: non-finite costs")
    clock.done("8")
    scale_out["times"] = scaleout_times(model, info)
    clock.done("9 (times)")

    # ---- profiles of phases 5 and 6, after every timed phase ----------------
    # device views: one MPC period of ticks, one solve
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        # kernels only: the CUDA side of a record_function range (the
        # solver's "sqp." stages) spans its kernels and is not one
        on_dev = [e for e in events if str(e.device_type).endswith("CUDA")
                  and not e.key.startswith("sqp.")]
        return (events, sum(e.count for e in on_dev),
                sum(dev_us(e) for e in on_dev) / 1e3, on_dev)

    _, n_k, d_ms, on_dev = profiled(period)
    k1_dev_ms = sum(dev_us(e) for e in on_dev if "hoqp_fused" in e.key) / 1e3
    print(f"[profile] per tick: {n_k / 10.0:.0f} kernels, "
          f"{d_ms / 10.0:.3f} ms device time (K1 {k1_dev_ms / 10.0:.3f} ms), "
          f"device busy {100.0 * d_ms / 10.0 / tick_ms:.1f}% of the "
          f"{tick_ms:.3f} ms tick; the tick after the profiler: "
          f"{_cuda_ms(period, reps=3) / 10.0:.3f} ms")
    solve_profiles = {}
    for label, fn, ms_ in (("serial", warm, mpc_ms),
                           ("parallel", lambda: warm(par), mpc_par_ms)):
        events, n_k, d_ms, _ = profiled(fn)
        # the record_function ranges of solver/sqp.py, host side (the CUDA
        # side of a range is listed under the same name with no host time)
        stages = {}
        for e in events:
            if e.key.startswith("sqp.") and not str(
                    e.device_type).endswith("CUDA"):
                stages[e.key] = stages.get(e.key, 0.0) + e.cpu_time_total / 1e3
        total = max(sum(stages.values()), 1e-9)
        solve_profiles[label] = dict(ms=ms_, kernels=n_k, device_ms=d_ms,
                                     riccati_host_ms=stages.get(
                                         "sqp.riccati", 0.0))
        print(f"[profile] one warm solve, {label} Riccati: {n_k} kernels, "
              f"{d_ms:.3f} ms device time, device busy "
              f"{100.0 * d_ms / ms_:.2f}% of the {ms_:.1f} ms solve; host ms "
              f"under the profiler: " + ", ".join(
                  f"{k[4:]} {v:.1f} ({100.0 * v / total:.0f}%)"
                  for k, v in sorted(stages.items())))
    n_k, d_ms = _device_profile(lambda: hoqp_solve(st))
    hoqp_prof = dict(ms=hoqp_ms, kernels=n_k, device_ms=d_ms)
    print(f"[profile] one pivoted cascade hoqp_solve: {n_k} kernels, "
          f"{d_ms:.3f} ms device time, device busy "
          f"{100.0 * d_ms / hoqp_ms:.1f}% of the {hoqp_ms:.1f} ms call")
    profile_batched_mpc(mpc_b, mpc_b_step)
    clock.done("5-6 (profiles)")
    paths = {"4 ticks": TICKS, "4b standing_ee_hold": launches,
             **{f"4c {n}": v for n, v in exp_launches.items()},
             "4d mpc_variant_standing": variant["launches"],
             "4e make_mpc_cycle(fused_wbc=True)": mpc_k1_launches,
             "4f LoopConfig(fused_wbc=False)": pivot_launches,
             "4g HardwareLoop inline": hw["inline"]["launches"],
             "4g HardwareLoop async, control thread":
                 hw["async"]["control_launches"],
             "4g HardwareLoop async, MPC worker thread":
                 hw["async"]["worker_launches"]}
    print(f"[kernels] K1-cold (hoqp_fused.cu, warm pointer null): launches "
          f"per path {paths} (4d and 4f run the pivoted cascade, as the JAX "
          f"package does; 4e: {mpc_k1_ticks} ticks on the MPC-only stack; "
          f"4g: {hw['inline']['ticks']} inline ticks, "
          f"{hw['async']['control_ticks']} async control ticks); "
          f"K1-warm (the same kernel with a warm buffer): "
          f"no path launches it, timed alone in phase 5; K1 with grid = "
          f"{BATCH}: {b_launches} launches of {b_blocks} blocks in phase 7's "
          f"{BATCH_CYCLES} batched cycles; phase 9 (per rank, grid = its "
          f"scenarios: {BATCH} on one rank, {BATCH // 2} on each of two): "
          f"{scale_out['launches']}")
    k1 = {"route": "cuda",
          "source": "qm_control_tpu_torch/kernels/csrc/hoqp_fused.cu",
          "replaces": "qm_control_tpu/kernels/hoqp_fused.py:619",
          "library_ms": None}
    bms, bbound, bby = k1_times[BATCH]
    print(json.dumps({"kernels": [
        dict(k1, name="hoqp_fused", launches=launches,
             max_abs_err=worst_real, ms=k1_ms, plain_ms=plain_ms,
             bound_ms=bound_ms,
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             launches_by_path=paths, warm_ms=k1_warm_ms,
             warm_bound_ms=warm_bound_ms, mpc_only_ms=k1_mpc_ms,
             mpc_only_bound_ms=mpc_bound_ms, mpc_only_bound_by=mpc_bound_by,
             mpc_only_max_abs_err=worst_mpc),
        dict(k1, name=f"hoqp_fused[grid={BATCH}]", launches=b_launches,
             blocks=b_blocks, batch=BATCH, max_abs_err=worst_batched,
             ms=bms, plain_ms=plain_batched_ms, bound_ms=bbound,
             bound_by=bby,
             ms_by_batch={str(b): v[0] for b, v in k1_times.items()},
             bound_ms_by_batch={str(b): v[1] for b, v in k1_times.items()},
             launches_scaleout=scale_out["launches"])],
        "mpc_solve_ms": mpc_ms, "cycle_ms": cycle_ms, "tick_ms": tick_ms,
        "chained_tick_ms": chained_tick_ms, "hardware": hw,
        "main_ticks": HOLD_TICKS, "experiments": exp_walls,
        "mpc_variant": variant, "hoqp_solve": hoqp_prof,
        "hoqp_batched_ms": hoqp_batched_ms, "hoqp_graph": hoqp_graph,
        "riccati": dict(solves=solve_profiles, cost_rel=par_dc, w_rel=par_dw,
                        lq_rel=lq_rel), "ilqr_err": ilqr_err,
        "batched_mpc": mpc_b,
        "batched_cycle_ms": b_cycle_ms, "rollouts": roll,
        "scaleout": scale_out,
        "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def mpc_batch_probe(B):
    """`chip_smoke.py --mpc-batch B`: phase 6 alone at B scenarios."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from qm_control_tpu_torch.models import centroidal as C
    from qm_control_tpu_torch.models import load_model
    smi = _smi()
    print(smi)
    model = load_model()
    out, run = batched_mpc(model, C.make_centroidal_info(model), B)
    profile_batched_mpc(out, run)
    print(json.dumps({"batched_mpc": out, "card": smi}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--main-path"]:
        sys.exit(main_path())
    if sys.argv[1:2] == ["--experiment"]:
        sys.exit(experiment_child(sys.argv[2]))
    if sys.argv[1:] == ["--mpc-variant"]:
        sys.exit(variant_child())
    if sys.argv[1:] == ["--hardware"]:
        sys.exit(hardware_child())
    if sys.argv[1:2] == ["--mpc-batch"]:
        sys.exit(mpc_batch_probe(int(sys.argv[2])))
    if sys.argv[1:] == ["--distributed"]:
        sys.exit(distributed_only())
    if sys.argv[1:] == ["--scaleout-rank"]:
        sys.exit(scaleout_rank())
    sys.exit(main())
