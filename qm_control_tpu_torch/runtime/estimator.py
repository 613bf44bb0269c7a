"""State estimation (port of the ground-truth half of
qm_control_tpu/runtime/estimator.py; reference StateEstimateBase /
FromTopicStateEstimate): the 55-dim rbdState

    rbdState(55) = [euler_zyx(3); base_pos(3); q_joints(18);
                    omega_world(3); base_lin_vel(3); qdot_joints(18);
                    ee_pose(7: pos + quat xyzw)]

and the centroidal observation with yaw unwrapping (QMController.cpp:
239-242). The IMU-path estimator comes in a later slice.
"""
import torch

from ..models import centroidal as C
from ..models import kinematics as K
from ..models.rotations import (R_to_quat, euler_zyx_rate_to_omega_world_matrix,
                                yaw_unwrap)
from ..models.spec import EE_FRAME, RobotModel


def rbd_state_from_plant(model: RobotModel, q, v):
    """(55,) rbdState from plant ground truth (q, v: base pos + ZYX euler
    + joints; plain-rate velocities)."""
    E = euler_zyx_rate_to_omega_world_matrix(q[3:6])
    omega_world = E @ v[3:6]
    ee_pos, ee_R = K.frame_pose(model, K.fk(model, q), EE_FRAME)
    ee_q = R_to_quat(ee_R)                      # wxyz
    return torch.cat([q[3:6], q[0:3], q[6:24],
                      omega_world, v[0:3], v[6:24],
                      ee_pos, ee_q[1:], ee_q[:1]])


def rbd_to_qv(rbd):
    """Invert the rbdState layout back to (q(24), v(24))."""
    q = torch.cat([rbd[3:6], rbd[0:3], rbd[6:24]])
    E = euler_zyx_rate_to_omega_world_matrix(rbd[0:3])
    zyx_dot = torch.linalg.solve_ex(E, rbd[24:27])[0]
    v = torch.cat([rbd[27:30], zyx_dot, rbd[30:48]])
    return q, v


def observation_from_rbd(model: RobotModel, info: C.CentroidalInfo, rbd,
                         last_yaw=None):
    """Centroidal observation x(30) from the rbdState, with yaw unwrap
    (reference QMController::updateStateEstimation :236-242)."""
    q, v = rbd_to_qv(rbd)
    if last_yaw is not None:
        q = torch.cat([q[:3], yaw_unwrap(q[3], last_yaw)[None], q[4:]])
    return C.centroidal_state_from_rbd(model, info, q, v)
