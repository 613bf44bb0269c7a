"""Robot model specification: static kinematic tree + inertial data.

Loads the JSON emitted by tools/extract_urdf.py (numeric robot parameters
for Unitree Aliengo + Kinova j2n6s300; extracted from the reference's
qm_description/urdf/qudraputed_manipulator/robot.urdf).

The floating base is modeled as 6 virtual single-DoF joints
(3 world-aligned prismatic: x,y,z; then revolute z,y,x), so generalized
coordinates are q = [p_base(3), euler_zyx(3), q_joints(18)] in R^24 and the
velocity coordinates are plain coordinate rates — exactly the reference's
parameterization (OCS2 CentroidalModelPinocchioMapping: base linear velocity
in world + ZYX-Euler rates; see SURVEY.md §1 key dimensions).

Canonical orderings (match the reference):
  joints:  LF(HAA,HFE,KFE), LH, RF, RH, arm joints 1-6  (task.info:168-188)
  contacts: LF_FOOT, RF_FOOT, LH_FOOT, RH_FOOT          (ModelSettings.h:38)

PyTorch port: a numpy-only copy of qm_control_tpu/models/spec.py, reading
its own byte-identical copy of the model JSON.
"""
import json
import os
from dataclasses import dataclass, field

import numpy as np

PRISMATIC, REVOLUTE = 0, 1

NUM_LEG_JOINTS = 12
NUM_ARM_JOINTS = 6
NUM_JOINTS = NUM_LEG_JOINTS + NUM_ARM_JOINTS   # 18 actuated
NUM_BASE = 6
NQ = NUM_BASE + NUM_JOINTS                      # 24 generalized coordinates
NUM_CONTACTS = 4

JOINT_NAMES = (
    "LF_HAA", "LF_HFE", "LF_KFE",
    "LH_HAA", "LH_HFE", "LH_KFE",
    "RF_HAA", "RF_HFE", "RF_KFE",
    "RH_HAA", "RH_HFE", "RH_KFE",
    "j2n6s300_joint_1", "j2n6s300_joint_2", "j2n6s300_joint_3",
    "j2n6s300_joint_4", "j2n6s300_joint_5", "j2n6s300_joint_6",
)
CONTACT_FRAMES = ("LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT")
EE_FRAME = "j2n6s300_end_effector"
BASE_FRAME = "base"

# indices of each contact's leg joints within the 18 actuated joints
# (contact order LF, RF, LH, RH; joint order LF, LH, RF, RH)
CONTACT_LEG_JOINTS = ((0, 1, 2), (6, 7, 8), (3, 4, 5), (9, 10, 11))

DEFAULT_MODEL_JSON = os.path.join(os.path.dirname(__file__),
                                  "aliengo_j2n6s300.json")


@dataclass(frozen=True)
class Frame:
    name: str
    body: int          # body index the frame is rigidly attached to
    p: np.ndarray      # offset in body frame
    R: np.ndarray      # orientation in body frame


@dataclass(frozen=True)
class RobotModel:
    """Static model data. All arrays are numpy (trace-time constants)."""
    name: str
    n_bodies: int                 # == NQ (one body per 1-DoF joint)
    joint_type: np.ndarray        # (NQ,) PRISMATIC/REVOLUTE
    parent: np.ndarray            # (NQ,) parent body index, -1 = world
    X_tree_R: np.ndarray          # (NQ,3,3) joint origin rotation in parent frame
    X_tree_p: np.ndarray          # (NQ,3)  joint origin offset in parent frame
    axis: np.ndarray              # (NQ,3) joint axis in joint frame
    mass: np.ndarray              # (NQ,)
    com: np.ndarray               # (NQ,3) body COM in body frame
    inertia: np.ndarray           # (NQ,3,3) about COM, body frame
    ancestor: np.ndarray          # (NQ,NQ) bool, ancestor[k,b]: joint k moves body b
    frames: dict = field(default_factory=dict)       # name -> Frame
    joint_lower: np.ndarray = None   # (18,)
    joint_upper: np.ndarray = None   # (18,)
    joint_effort: np.ndarray = None  # (18,) torque limits
    joint_velocity: np.ndarray = None  # (18,)
    total_mass: float = 0.0

    @property
    def nq(self):
        return self.n_bodies

    def frame(self, name):
        return self.frames[name]


def load_model(path: str = DEFAULT_MODEL_JSON) -> RobotModel:
    with open(path) as f:
        spec = json.load(f)

    n = NUM_BASE + len(spec["joints"])
    joint_type = np.zeros(n, dtype=np.int32)
    parent = np.zeros(n, dtype=np.int32)
    X_R = np.tile(np.eye(3), (n, 1, 1))
    X_p = np.zeros((n, 3))
    axis = np.zeros((n, 3))
    mass = np.zeros(n)
    com = np.zeros((n, 3))
    inertia = np.zeros((n, 3, 3))

    # virtual floating-base chain: prismatic x,y,z then revolute z,y,x
    base_axes = [(PRISMATIC, [1, 0, 0]), (PRISMATIC, [0, 1, 0]),
                 (PRISMATIC, [0, 0, 1]), (REVOLUTE, [0, 0, 1]),
                 (REVOLUTE, [0, 1, 0]), (REVOLUTE, [1, 0, 0])]
    for i, (t, a) in enumerate(base_axes):
        joint_type[i] = t
        parent[i] = i - 1
        axis[i] = a
    # base body rides on the last virtual joint (index 5)
    root = spec["root"]
    mass[5] = root["mass"]
    com[5] = root["com"]
    inertia[5] = root["inertia"]

    name_to_body = {"__root__": 5}
    jnames = [j["name"] for j in spec["joints"]]
    assert tuple(jnames) == JOINT_NAMES, jnames
    lower, upper, effort, vel = [], [], [], []
    for k, j in enumerate(spec["joints"]):
        i = NUM_BASE + k
        name_to_body[j["name"]] = i
        joint_type[i] = REVOLUTE if j["type"] == "revolute" else PRISMATIC
        parent[i] = name_to_body[j["parent"]]
        X_R[i] = j["R"]
        X_p[i] = j["p"]
        axis[i] = j["axis"]
        mass[i] = j["mass"]
        com[i] = j["com"]
        inertia[i] = j["inertia"]
        lim = j["limit"] or {}
        lower.append(lim.get("lower", -np.inf))
        upper.append(lim.get("upper", np.inf))
        effort.append(lim.get("effort", np.inf))
        vel.append(lim.get("velocity", np.inf))

    ancestor = np.zeros((n, n), dtype=bool)
    for b in range(n):
        k = b
        while k >= 0:
            ancestor[k, b] = True
            k = parent[k]

    frames = {}
    for fname, fr in spec["frames"].items():
        frames[fname] = Frame(fname, name_to_body[fr["parent"]],
                              np.asarray(fr["p"]), np.asarray(fr["R"]))

    return RobotModel(
        name=spec["name"], n_bodies=n, joint_type=joint_type, parent=parent,
        X_tree_R=X_R, X_tree_p=X_p, axis=axis, mass=mass, com=com,
        inertia=inertia, ancestor=ancestor, frames=frames,
        joint_lower=np.asarray(lower), joint_upper=np.asarray(upper),
        joint_effort=np.asarray(effort), joint_velocity=np.asarray(vel),
        total_mass=float(spec["total_mass"]),
    )


def submodel(model: RobotModel, bodies, frame_names):
    """Reindexed RobotModel over an ancestor-closed body subset.

    `bodies` must be in topological order (parent before child). Returns
    (sub, q_idx) where q_idx are the generalized-coordinate indices of the
    kept bodies in the full model — use q_sub = q[q_idx].

    Purpose: the MPC stage functions only need the FEET (bodies 0-17: base
    chain + 12 leg joints) and the ARM EE (base chain + 6 arm joints).
    Running FK on a 12-18 body submodel with fk_unrolled keeps the traced
    graph tiny (~200 primitives, no scan) — this is what makes the MPC
    step trace in ~1 s instead of ~30 s and lets XLA fuse the whole chain.
    """
    bodies = list(bodies)
    index = {b: i for i, b in enumerate(bodies)}
    for b in bodies:
        p = int(model.parent[b])
        assert p < 0 or p in index, f"subset not ancestor-closed at body {b}"
    sel = np.asarray(bodies)
    parent = np.asarray([index[int(model.parent[b])]
                         if int(model.parent[b]) >= 0 else -1
                         for b in bodies], dtype=np.int32)
    frames = {}
    for name in frame_names:
        fr = model.frames[name]
        frames[name] = Frame(name, index[fr.body], fr.p, fr.R)
    sub = RobotModel(
        name=model.name + f"_sub{len(bodies)}", n_bodies=len(bodies),
        joint_type=model.joint_type[sel], parent=parent,
        X_tree_R=model.X_tree_R[sel], X_tree_p=model.X_tree_p[sel],
        axis=model.axis[sel], mass=model.mass[sel], com=model.com[sel],
        inertia=model.inertia[sel],
        ancestor=model.ancestor[np.ix_(sel, sel)], frames=frames,
        joint_lower=model.joint_lower, joint_upper=model.joint_upper,
        joint_effort=model.joint_effort, joint_velocity=model.joint_velocity,
        total_mass=model.total_mass)
    return sub, sel


_SUBMODEL_CACHE = {}


def legs_submodel(model: RobotModel):
    """(sub, q_idx): base chain + 12 leg joints, with the contact frames
    and base frame. q_idx == arange(18) (legs are a prefix of the tree)."""
    key = (id(model), "legs")
    if key not in _SUBMODEL_CACHE:
        _SUBMODEL_CACHE[key] = submodel(
            model, range(NUM_BASE + NUM_LEG_JOINTS),
            list(CONTACT_FRAMES) + [BASE_FRAME])
    return _SUBMODEL_CACHE[key]


def arm_submodel(model: RobotModel):
    """(sub, q_idx): base chain + 6 arm joints, with the EE frame."""
    key = (id(model), "arm")
    if key not in _SUBMODEL_CACHE:
        arm_bodies = list(range(NUM_BASE)) + list(
            range(NUM_BASE + NUM_LEG_JOINTS, NUM_BASE + NUM_JOINTS))
        _SUBMODEL_CACHE[key] = submodel(
            model, arm_bodies, [EE_FRAME, BASE_FRAME])
    return _SUBMODEL_CACHE[key]


# default joint configuration (reference task.info:168-188 / reference.info)
DEFAULT_JOINT_STATE = np.array([
    0.00, 0.80, -1.50,   # LF
    0.00, 0.80, -1.50,   # LH
    0.00, 0.80, -1.50,   # RF
    0.00, 0.80, -1.50,   # RH
    3.14, 3.61, 0.86, 2.70, 1.37, -0.40,  # arm
])


def default_q(base_pos=(0.0, 0.0, 0.4), base_zyx=(0.0, 0.0, 0.0)):
    return np.concatenate([np.asarray(base_pos, dtype=np.float64),
                           np.asarray(base_zyx, dtype=np.float64),
                           DEFAULT_JOINT_STATE])
