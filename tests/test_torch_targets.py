"""PyTorch port vs JAX reference: the target command conversions
(ocp/reference.py: goal_pose_to_target, cmd_vel_to_target,
ee_cmd_vel_to_target) and the command layer (runtime/commands.py:
GaitCommander, TargetCommander, CommandQueue).

The conversions run on the cases of tests/test_targets.py and on seeded
random poses and commands, from the same numpy inputs in both packages.
Both do the knot arithmetic in float64 numpy and the rotations in f32,
so the padded knots agree within 1e-6 max(1, |a|) and the knot times
exactly; the returned last-EE targets agree to the same bound.
"""
import numpy as np
import pytest
import torch

from qm_control_tpu.config import ReferenceConfig as JRef
from qm_control_tpu.ocp import reference as JR
from qm_control_tpu.runtime import commands as JCmd
from qm_control_tpu_torch.config import ReferenceConfig as TRef
from qm_control_tpu_torch.ocp import reference as TR
from qm_control_tpu_torch.runtime import commands as TCmd

torch.set_num_threads(1)


def _knots_close(jt, tt):
    jtimes, jstates = np.asarray(jt.times), np.asarray(jt.states)
    assert tt.times.dtype == torch.float32 and tt.times.device.type == "cpu"
    np.testing.assert_array_equal(tt.times.numpy(), jtimes)
    gap = np.abs(tt.states.numpy().astype(np.float64) - jstates)
    assert (gap <= 1e-6 * np.maximum(1.0, np.abs(jstates))).all(), gap.max()


def _last_close(j, t):
    j, t = np.asarray(j, np.float64), np.asarray(t, np.float64)
    assert (np.abs(t - j) <= 1e-6 * np.maximum(1.0, np.abs(j))).all()


def _unit(rng, n=4):
    q = rng.standard_normal(n)
    return q / np.linalg.norm(q)


def _case(seed):
    """(obs_state (30,), ee_state (7,), last_ee (7,)) of tests/
    test_targets.py (seed < 0) or drawn from default_rng(seed)."""
    if seed < 0:
        obs = np.zeros(30)
        obs[6:12] = [0.1, 0.2, 0.38, 0.3, 0.01, -0.02]
        ee = np.array([0.6, 0.3, 0.5, 0, 0, 0, 1.0])
        return obs, ee, ee.copy()
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.0, 0.3, 30)
    obs[6:12] = [*rng.uniform(-1, 1, 2), rng.uniform(0.3, 0.45),
                 *rng.uniform(-np.pi, np.pi, 1), *rng.uniform(-0.2, 0.2, 2)]
    ee = np.concatenate([rng.uniform(-1, 1, 3), _unit(rng)])
    # half the draws within 10 cm of the EE (held), half beyond (latched)
    far = 0.05 if seed % 2 else 0.5
    last = np.concatenate([ee[:3] + far * _unit(rng, 3), _unit(rng)])
    return obs, ee.astype(np.float32), last


SEEDS = [-1] + list(range(8))


@pytest.mark.parametrize("seed", SEEDS)
def test_goal_pose_to_target_matches_jax(seed):
    obs, ee, _ = _case(seed)
    rng = np.random.default_rng(100 + seed)
    pos, quat = ([1.0, 0.3, 0.6], [1, 0, 0, 0]) if seed < 0 else (
        rng.uniform(-1, 1, 3), _unit(rng))
    jt = JR.goal_pose_to_target(pos, quat, 2.0, obs, ee, JRef())
    tt = TR.goal_pose_to_target(pos, quat, 2.0, obs, ee, TRef(),
                                device="cpu")
    _knots_close(jt, tt)


@pytest.mark.parametrize("seed", SEEDS)
def test_cmd_vel_to_target_matches_jax(seed):
    obs, ee, last = _case(seed)
    if seed < 0:    # tests/test_targets.py: yawed 90 deg
        obs[6:12] = [0, 0, 0.4, np.pi / 2, 0, 0]
        cmd = [0.2, 0, 0, 0.1]
    else:
        cmd = np.random.default_rng(200 + seed).uniform(-0.3, 0.3, 4)
    jt, jl = JR.cmd_vel_to_target(cmd, last, 0.7, obs, ee, JRef())
    tt, tl = TR.cmd_vel_to_target(cmd, last, 0.7, obs, ee, TRef(),
                                  device="cpu")
    _knots_close(jt, tt)
    _last_close(jl, tl)


@pytest.mark.parametrize("seed", SEEDS)
def test_ee_cmd_vel_to_target_matches_jax(seed):
    obs, ee, last = _case(seed)
    if seed < 0:    # tests/test_targets.py: the nominal tool orientation
        q_nominal = np.array([0.5, -0.5, 0.5, -0.5])
        obs[6:12] = [0, 0, 0.4, 0, 0, 0]
        ee = np.concatenate([[0.5, 0.1, 0.5], q_nominal])
        last = np.concatenate([[0.4, 0.1, 0.45], q_nominal])
        cmd = [0.1, 0.0, 0.0, 0.0]
    else:
        cmd = np.random.default_rng(300 + seed).uniform(-0.3, 0.3, 4)
    jt, jl = JR.ee_cmd_vel_to_target(cmd, last, 1.5, obs, ee, JRef())
    tt, tl = TR.ee_cmd_vel_to_target(cmd, last, 1.5, obs, ee, TRef(),
                                     device="cpu")
    _knots_close(jt, tt)
    _last_close(jl, tl)


def test_time_to_target_and_constants_match_jax():
    np.testing.assert_array_equal(TR.EE_BASE_OFFSET, JR.EE_BASE_OFFSET)
    assert TR.TIME_TO_TARGET == JR.TIME_TO_TARGET
    for seed in range(4):
        delta = np.random.default_rng(seed).normal(0, 0.5, 6)
        assert TR.estimate_time_to_target(delta, TRef()) == \
            JR.estimate_time_to_target(delta, JRef())


def _schedule_equal(jms, tms):
    np.testing.assert_array_equal(tms.event_times.numpy(),
                                  np.asarray(jms.event_times))
    np.testing.assert_array_equal(tms.modes.numpy(), np.asarray(jms.modes))


def test_gait_commander_matches_jax():
    """tests/test_commands_utils.py's switch and joy sequence, then every
    binding and a keyboard switch: the same mode schedules."""
    assert TCmd.JOY_GAIT_BINDINGS == JCmd.JOY_GAIT_BINDINGS
    jg, tg = JCmd.GaitCommander(), TCmd.GaitCommander(device="cpu")
    _schedule_equal(jg.mode_schedule(0.0, 2.0), tg.mode_schedule(0.0, 2.0))
    for buttons, t in (({"LB": True, "A": True}, 1.0), ({"LB": True}, 2.0),
                       ({"LB": True, "Y": True, "A": False}, 2.5),
                       ({"LB": True, "X": True}, 3.7),
                       ({"LB": True, "B": True}, 4.1)):
        assert tg.joy(buttons, t) == jg.joy(buttons, t)
        _schedule_equal(jg.mode_schedule(0.0, t + 2.0),
                        tg.mode_schedule(0.0, t + 2.0))
    jg.switch("trot", 5.0)
    tg.switch("trot", 5.0)
    _schedule_equal(jg.mode_schedule(4.0, 7.0), tg.mode_schedule(4.0, 7.0))
    with pytest.raises(KeyError):
        tg.switch("moonwalk", 0.0)


def test_target_commander_matches_jax():
    """tests/test_commands_utils.py's three conversions, then a seeded
    sequence of commands: the same targets and lastEeTarget state."""
    jc, tc = JCmd.TargetCommander(), TCmd.TargetCommander(device="cpu")
    obs = np.zeros(30)
    obs[6:12] = [0, 0, 0.4, 0, 0, 0]
    ee = np.array([0.52, 0.09, 0.78, 0.5, -0.5, 0.5, -0.5])
    _knots_close(jc.cmd_vel([0.1, 0, 0, 0], 0.0, obs, ee),
                 tc.cmd_vel([0.1, 0, 0, 0], 0.0, obs, ee))
    _knots_close(jc.goal_pose([0.8, 0.2, 0.7], [1, 0, 0, 0], 0.0, obs, ee),
                 tc.goal_pose([0.8, 0.2, 0.7], [1, 0, 0, 0], 0.0, obs, ee))
    _last_close(jc.last_ee_target, tc.last_ee_target)
    _knots_close(jc.ee_cmd_vel([0.05, 0, 0, 0], 0.0, obs, ee),
                 tc.ee_cmd_vel([0.05, 0, 0, 0], 0.0, obs, ee))
    rng = np.random.default_rng(7)
    for k in range(6):
        obs, ee, _ = _case(k)
        v = rng.uniform(-0.2, 0.2, 4)
        kind = ("cmd_vel", "ee_cmd_vel")[k % 2]
        _knots_close(getattr(jc, kind)(v, 0.1 * k, obs, ee),
                     getattr(tc, kind)(v, 0.1 * k, obs, ee))
        _last_close(jc.last_ee_target, tc.last_ee_target)


@pytest.mark.parametrize("maxsize,n", [(2, 5), (64, 10), (1, 1)])
def test_command_queue_matches_jax(maxsize, n):
    jq, tq = JCmd.CommandQueue(maxsize), TCmd.CommandQueue(maxsize)
    for i in range(n):
        jq.publish(i)
        tq.publish(i)
    assert tq.drain() == jq.drain()
    assert tq.drain() == [] == jq.drain()


def test_device_rule():
    """The new entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    obs, ee, last = _case(-1)
    for call in (lambda: TR.goal_pose_to_target([1, 0, 0.5], [1, 0, 0, 0],
                                                0.0, obs, ee, TRef()),
                 lambda: TR.cmd_vel_to_target([0.1, 0, 0, 0], last, 0.0, obs,
                                              ee, TRef()),
                 lambda: TR.ee_cmd_vel_to_target([0.1, 0, 0, 0], last, 0.0,
                                                 obs, ee, TRef()),
                 TCmd.GaitCommander, TCmd.TargetCommander):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
