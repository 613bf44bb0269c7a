"""Typed configuration tree + boost-ptree `.info` file ingestion.

One typed config system replacing the reference's three mechanisms
(SURVEY.md §5 Config):
  1. OCS2 `.info` property-tree files (task.info / reference.info / gait.info)
     -> `parse_info()` + `load_task_config()` ingest the reference values
        verbatim for A/B parity.
  2. ROS params / YAML            -> plain dataclass fields with defaults.
  3. dynamic_reconfigure live gain tuning -> `WbcGains` is a plain
     dataclass carried as a runtime argument, so gains can change between
     calls.

PyTorch port: a numpy-only copy of qm_control_tpu/config.py (the port
imports nothing of the JAX package).

Defaults below replicate the reference's qm_controllers/config/task.info,
reference.info and the dynamic_reconfigure defaults in
qm_wbc/cfg/wbcWigeht.cfg + qm_controllers/cfg/weight.cfg.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# boost::property_tree INFO format parser (the format OCS2 LoadData reads).
# Grammar subset: `key value`, `key { ... }`, comments with `;` or `//`,
# quoted strings, matrix entries `(i,j) value`.
# ---------------------------------------------------------------------------


def _tokenize_info(text: str):
    # strip ; and // comments (the reference uses both), keep quoted strings
    lines = []
    for raw in text.splitlines():
        line = raw
        # remove // comments
        line = re.sub(r"//.*", "", line)
        # remove ; comments (everything after first ';' not inside quotes)
        out, inq = [], False
        for ch in line:
            if ch == '"':
                inq = not inq
            if ch == ";" and not inq:
                break
            out.append(ch)
        lines.append("".join(out))
    text = "\n".join(lines)
    token_re = re.compile(r'"[^"]*"|\{|\}|\[[^\]]*\]|\([^)]*\)|[^\s{}]+')
    return token_re.findall(text)


def parse_info(text: str) -> dict:
    """Parse boost INFO text into a nested dict of str->(str|dict)."""
    tokens = _tokenize_info(text)
    root: dict = {}
    stack = [root]
    key = None
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "{":
            child: dict = {}
            if key is None:
                raise ValueError("'{' without a key")
            stack[-1][key] = child
            stack.append(child)
            key = None
        elif tok == "}":
            if key is not None:
                stack[-1][key] = ""
                key = None
            stack.pop()
        else:
            val = tok[1:-1] if tok.startswith('"') else tok
            if key is None:
                key = val
            else:
                stack[-1][key] = val
                key = None
        i += 1
    if key is not None:
        root[key] = ""
    return root


def info_matrix(node: dict, n: int, m: int = 1) -> np.ndarray:
    """Extract a matrix written as `(i,j) value` entries (OCS2 style)."""
    out = np.zeros((n, m))
    for k, v in node.items():
        mm = re.match(r"\((\d+),(\d+)\)", k)
        if mm:
            out[int(mm.group(1)), int(mm.group(2))] = float(v)
    return out if m > 1 else out[:, 0]


def info_indexed_list(node: dict) -> list:
    """Extract a list written as `[i] value` entries."""
    items = []
    for k, v in node.items():
        mm = re.match(r"\[(\d+)\]", k)
        if mm:
            items.append((int(mm.group(1)), v))
    return [v for _, v in sorted(items)]


def _f(node, key, default):
    v = node.get(key, default)
    try:
        return float(v)
    except (TypeError, ValueError):
        return default


def _b(node, key, default):
    v = str(node.get(key, default)).lower()
    return v in ("true", "1")


# ---------------------------------------------------------------------------
# Typed config dataclasses (defaults == reference task.info values)
# ---------------------------------------------------------------------------

# reference task.info:150-181 Q diagonal (30)
_Q_DIAG = [50.0, 50.0, 300.0, 10.0, 30.0, 30.0,                 # momentum
           1000.0, 1000.0, 3000.0, 1000.0, 2000.0, 2000.0,      # base pose
           5.0, 5.0, 2.5, 5.0, 5.0, 2.5, 5.0, 5.0, 2.5, 5.0, 5.0, 2.5,  # legs
           0.0, 0.0, 5.0, 0.0, 0.0, 0.0]                        # arm
# reference task.info:196-233 R diagonal (30), scaling 1e-3.
# Entries 12..23 weight FOOT VELOCITY RELATIVE TO BASE; they are mapped
# through the stance-leg Jacobian at the nominal configuration
# (QMInterface.cpp:274-299) by ocp.costs.leg_velocity_R_block.
_R_DIAG = [5.0] * 12 + [5000.0] * 12 + [1000.0] * 6


@dataclass(frozen=True)
class MpcConfig:
    time_horizon: float = 1.0          # task.info mpc.timeHorizon
    dt: float = 0.015                  # task.info sqp.dt
    num_iterations: int = 1            # sqpIteration
    mpc_frequency: float = 100.0       # mpcDesiredFrequency
    mrt_frequency: float = 1000.0      # mrtDesiredFrequency
    integrator: str = "rk2"            # sqp.integratorType RK2
    cold_start: bool = False
    # Structured (analytic) stage linearization (ocp/linearize.py):
    # same outputs as the fused-autodiff path at f32 roundoff
    # (tests/test_linearize.py), 1.24x faster and -27% HBM bytes at
    # B=256 on v5e. False selects the 60-tangent jax.linearize path
    # (kept as the independent cross-check the tests compare against).
    structured_linearize: bool = True

    @property
    def num_nodes(self) -> int:
        """Intermediate nodes over the horizon (N intervals, N+1 states)."""
        return int(round(self.time_horizon / self.dt))


@dataclass(frozen=True)
class CostConfig:
    q_diag: Tuple[float, ...] = tuple(_Q_DIAG)      # task.info Q
    q_scaling: float = 1.0
    r_diag: Tuple[float, ...] = tuple(_R_DIAG)      # task.info R
    r_scaling: float = 1e-3
    ee_mu_position: float = 2000.0      # task.info endEffector.muPosition
    ee_mu_orientation: float = 1000.0   # endEffector.muOrientation
    final_ee_mu_position: float = 2000.0
    final_ee_mu_orientation: float = 1000.0


@dataclass(frozen=True)
class FrictionConfig:
    friction_coefficient: float = 0.3   # task.info frictionConeSoftConstraint
    barrier_mu: float = 0.1
    barrier_delta: float = 5.0


@dataclass(frozen=True)
class JointLimitsConfig:
    position_mu: float = 0.1            # task.info jointPositionLimits
    position_delta: float = 1e-3
    velocity_mu: float = 0.1            # task.info jointVelocityLimits
    velocity_delta: float = 1e-3
    # arm velocity bounds (task.info jointVelocityLimits lower/upperBound.arm)
    arm_velocity_lower: Tuple[float, ...] = (-0.628, -0.628, -0.628,
                                             -0.837, -0.837, -0.837)
    arm_velocity_upper: Tuple[float, ...] = (0.628, 0.628, 0.628,
                                             0.837, 0.837, 0.837)


@dataclass(frozen=True)
class SwingPlannerConfig:
    lift_off_velocity: float = 0.05       # task.info swing_trajectory_config
    touch_down_velocity: float = -0.1
    swing_height: float = 0.15
    touchdown_after_horizon: float = 0.2
    swing_time_scale: float = 0.15


@dataclass(frozen=True)
class ModelConfig:
    position_error_gain: float = 0.0      # model_settings.positionErrorGain
    phase_transition_stance_time: float = 0.1
    base_frame: str = "base"
    ee_frame: str = "j2n6s300_end_effector"


@dataclass(frozen=True)
class ReferenceConfig:
    # reference.info
    target_displacement_velocity: float = 0.3
    target_rotation_velocity: float = 0.1
    com_height: float = 0.4
    default_joint_state: Tuple[float, ...] = (
        0.0, 0.8, -1.5, 0.0, 0.8, -1.5, 0.0, 0.8, -1.5, 0.0, 0.8, -1.5,
        3.14, 3.61, 0.86, 2.7, 1.37, -0.4)


@dataclass(frozen=True)
class WbcGains:
    """Runtime-mutable WBC gains (reference wbcWigeht.cfg defaults).

    Carried as a plain value argument through the WBC calls, so gains can
    change between ticks — the dynamic_reconfigure equivalent
    (SURVEY.md §5 config).
    """
    kp_swing: float = 350.0
    kd_swing: float = 37.0
    base_height_kp: float = 400.0
    base_height_kd: float = 140.0
    kp_base_linear: float = 400.0
    kd_base_linear: float = 100.0
    kp_base_angular: float = 400.0
    kd_base_angular: float = 140.0
    kp_arm_joints: Tuple[float, ...] = (4000., 4200., 4000., 4000., 4200., 6000.)
    kd_arm_joints: Tuple[float, ...] = (75.,) * 6
    kp_ee_linear: Tuple[float, ...] = (3000.,) * 3
    kd_ee_linear: Tuple[float, ...] = (75.,) * 3
    kp_ee_angular: Tuple[float, ...] = (2000.,) * 3
    kd_ee_angular: Tuple[float, ...] = (75.,) * 3
    swing_task_weight: float = 100.0      # HierarchicalWbc.cpp:29
    friction_coefficient: float = 0.3     # task.info frictionConeTask
    # arm hybrid-joint command gains (qm_controllers/cfg/weight.cfg)
    kp_arm_wbc: float = 0.0
    kd_arm_wbc: float = 0.5
    # arm-settling staging duration (reference hard-codes 10 s,
    # HierarchicalWbc.cpp:32; configurable here)
    arm_settling_time: float = 10.0


@dataclass(frozen=True)
class QmConfig:
    """Root config tree."""
    mpc: MpcConfig = field(default_factory=MpcConfig)
    cost: CostConfig = field(default_factory=CostConfig)
    friction: FrictionConfig = field(default_factory=FrictionConfig)
    joint_limits: JointLimitsConfig = field(default_factory=JointLimitsConfig)
    swing: SwingPlannerConfig = field(default_factory=SwingPlannerConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    reference: ReferenceConfig = field(default_factory=ReferenceConfig)
    wbc: WbcGains = field(default_factory=WbcGains)

    def with_(self, **kw) -> "QmConfig":
        return replace(self, **kw)


def load_task_config(task_info_path: str = None,
                     reference_info_path: str = None) -> QmConfig:
    """Build a QmConfig, optionally ingesting reference .info files.

    With no paths, returns the built-in defaults (already the reference
    values). With paths, every recognized key in the files overrides the
    default — this is the A/B-parity ingestion path.
    """
    cfg = QmConfig()
    if task_info_path:
        with open(task_info_path) as f:
            t = parse_info(f.read())
        sqp = t.get("sqp", {})
        mpc = t.get("mpc", {})
        cfg = replace(cfg, mpc=MpcConfig(
            time_horizon=_f(mpc, "timeHorizon", 1.0),
            dt=_f(sqp, "dt", 0.015),
            num_iterations=int(_f(sqp, "sqpIteration", 1)),
            mpc_frequency=_f(mpc, "mpcDesiredFrequency", 100.0),
            mrt_frequency=_f(mpc, "mrtDesiredFrequency", 1000.0),
            integrator=str(sqp.get("integratorType", "RK2")).lower(),
            cold_start=_b(mpc, "coldStart", False)))
        q = info_matrix(t.get("Q", {}), 30, 30) if "Q" in t else np.diag(_Q_DIAG)
        r = info_matrix(t.get("R", {}), 30, 30) if "R" in t else np.diag(_R_DIAG)
        ee, fee = t.get("endEffector", {}), t.get("finalEndEffector", {})
        cfg = replace(cfg, cost=CostConfig(
            q_diag=tuple(np.diag(q)), q_scaling=_f(t.get("Q", {}), "scaling", 1.0),
            r_diag=tuple(np.diag(r)), r_scaling=_f(t.get("R", {}), "scaling", 1e-3),
            ee_mu_position=_f(ee, "muPosition", 2000.0),
            ee_mu_orientation=_f(ee, "muOrientation", 1000.0),
            final_ee_mu_position=_f(fee, "muPosition", 2000.0),
            final_ee_mu_orientation=_f(fee, "muOrientation", 1000.0)))
        fr = t.get("frictionConeSoftConstraint", {})
        cfg = replace(cfg, friction=FrictionConfig(
            friction_coefficient=_f(fr, "frictionCoefficient", 0.3),
            barrier_mu=_f(fr, "mu", 0.1), barrier_delta=_f(fr, "delta", 5.0)))
        jp, jv = t.get("jointPositionLimits", {}), t.get("jointVelocityLimits", {})
        lo = info_matrix(jv.get("lowerBound", {}).get("arm", {}), 6) \
            if "lowerBound" in jv else np.array(JointLimitsConfig().arm_velocity_lower)
        hi = info_matrix(jv.get("upperBound", {}).get("arm", {}), 6) \
            if "upperBound" in jv else np.array(JointLimitsConfig().arm_velocity_upper)
        cfg = replace(cfg, joint_limits=JointLimitsConfig(
            position_mu=_f(jp, "mu", 0.1), position_delta=_f(jp, "delta", 1e-3),
            velocity_mu=_f(jv, "mu", 0.1), velocity_delta=_f(jv, "delta", 1e-3),
            arm_velocity_lower=tuple(lo), arm_velocity_upper=tuple(hi)))
        sw = t.get("swing_trajectory_config", {})
        cfg = replace(cfg, swing=SwingPlannerConfig(
            lift_off_velocity=_f(sw, "liftOffVelocity", 0.05),
            touch_down_velocity=_f(sw, "touchDownVelocity", -0.1),
            swing_height=_f(sw, "swingHeight", 0.15),
            touchdown_after_horizon=_f(sw, "touchdownAfterHorizon", 0.2),
            swing_time_scale=_f(sw, "swingTimeScale", 0.15)))
        ms = t.get("model_settings", {})
        cfg = replace(cfg, model=ModelConfig(
            position_error_gain=_f(ms, "positionErrorGain", 0.0),
            phase_transition_stance_time=_f(ms, "phaseTransitionStanceTime", 0.1)))
        wt = t.get("frictionConeTask", {})
        cfg = replace(cfg, wbc=replace(
            cfg.wbc, friction_coefficient=_f(wt, "frictionCoefficient", 0.3)))
    if reference_info_path:
        with open(reference_info_path) as f:
            r = parse_info(f.read())
        djs = info_matrix(r.get("defaultJointState", {}), 18) \
            if "defaultJointState" in r else np.array(ReferenceConfig().default_joint_state)
        cfg = replace(cfg, reference=ReferenceConfig(
            target_displacement_velocity=_f(r, "targetDisplacementVelocity", 0.3),
            target_rotation_velocity=_f(r, "targetRotationVelocity", 0.1),
            com_height=_f(r, "comHeight", 0.4),
            default_joint_state=tuple(djs)))
    return cfg
