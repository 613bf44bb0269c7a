"""State estimation (port of qm_control_tpu/runtime/estimator.py;
reference StateEstimateBase / FromTopicStateEstimate): the 55-dim rbdState

    rbdState(55) = [euler_zyx(3); base_pos(3); q_joints(18);
                    omega_world(3); base_lin_vel(3); qdot_joints(18);
                    ee_pose(7: pos + quat xyzw)]

and the centroidal observation with yaw unwrapping (QMController.cpp:
239-242). Two sources: the plant's ground truth ("cheater" estimator,
`rbd_state_from_plant`) and the sensor-level IMU path of the hardware
seam (`imu_estimator_update`, `imu_from_plant`).
"""
from typing import NamedTuple

import torch

from ..models import centroidal as C
from ..models import kinematics as K
from ..models.rotations import (R_to_euler_zyx, R_to_quat,
                                euler_zyx_rate_to_omega_world_matrix,
                                euler_zyx_to_R, quat_mul, quat_to_R,
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


# ---------------------------------------------------------------------------
# IMU-path estimator (the hardware seam)
# ---------------------------------------------------------------------------

class ImuEstimatorState(NamedTuple):
    """One-step estimator memory (reference StateEstimateBase latches the
    first IMU orientation sample as an offset, StateEstimateBase.cpp:50-55)."""
    zyx_offset: torch.Tensor    # (3,) latched first-sample orientation
    initialized: torch.Tensor   # scalar 0/1


def init_imu_estimator(device="cuda", dtype=torch.float32) -> ImuEstimatorState:
    from .. import resolve_device
    dev = resolve_device(device)
    return ImuEstimatorState(zyx_offset=torch.zeros(3, dtype=dtype, device=dev),
                             initialized=torch.zeros((), dtype=dtype,
                                                     device=dev))


def imu_estimator_update(model: RobotModel, est: ImuEstimatorState,
                         imu_quat_wxyz, gyro_local, joint_pos, joint_vel,
                         base_pos, base_lin_vel, contact_flags):
    """rbdState(55) from sensor-level inputs: IMU orientation and local
    angular rate, joint encoders, contact flags, and a base position /
    velocity source (odometry). Mirrors StateEstimateBase::updateImu
    (StateEstimateBase.cpp:46-68): the FIRST sample's ZYX angles are
    latched and subtracted from every later sample, and the local rate
    converts to the global one through the two rotation-derivative
    transforms: zyx_dot from (raw zyx, w_local), then
    w_global = E(offset-removed zyx) @ zyx_dot. The inputs go to the
    device and dtype of `joint_pos`.

    Returns (rbd(55), mode, new_est_state)."""
    from ..gaits.gait import mode_from_contact_flags
    joint_pos = torch.as_tensor(joint_pos)
    dtype, dev = joint_pos.dtype, joint_pos.device

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    zyx_raw = R_to_euler_zyx(quat_to_R(t(imu_quat_wxyz)))
    offset = torch.where(est.initialized > 0, est.zyx_offset, zyx_raw)
    zyx = zyx_raw - offset
    # w_local = R(zyx_raw)^T E(zyx_raw) zyx_dot  ->  solve for zyx_dot
    E_raw = euler_zyx_rate_to_omega_world_matrix(zyx_raw)
    zyx_dot = torch.linalg.solve_ex(euler_zyx_to_R(zyx_raw).T @ E_raw,
                                    t(gyro_local))[0]
    omega_world = euler_zyx_rate_to_omega_world_matrix(zyx) @ zyx_dot
    base_pos = t(base_pos)
    q = torch.cat([base_pos, zyx, joint_pos])
    ee_pos, ee_R = K.frame_pose(model, K.fk(model, q), EE_FRAME)
    ee_q = R_to_quat(ee_R)
    rbd = torch.cat([zyx, base_pos, joint_pos, omega_world, t(base_lin_vel),
                     t(joint_vel), ee_pos, ee_q[1:], ee_q[:1]])
    mode = mode_from_contact_flags(torch.as_tensor(contact_flags, device=dev))
    new_est = ImuEstimatorState(zyx_offset=offset,
                                initialized=torch.ones((), dtype=dtype,
                                                       device=dev))
    return rbd, mode, new_est


def apply_imu_noise(quat, gyro_local, gyro_draw, quat_draw, gyro_sigma,
                    quat_sigma):
    """Noisy IMU sample from standard-normal draws (3,) each: the gyro
    gets gyro_sigma * gyro_draw, the orientation a small-angle quaternion
    perturbation of quat_sigma * quat_draw."""
    gyro_local = gyro_local + gyro_sigma * gyro_draw
    dq = quat_sigma * quat_draw
    pert = torch.cat([torch.ones_like(dq[:1]), 0.5 * dq])
    return quat_mul(pert / torch.linalg.vector_norm(pert), quat), gyro_local


def imu_from_plant(model: RobotModel, q, v, generator=None, gyro_sigma=0.0,
                   quat_sigma=0.0):
    """An IMU sample (quat_wxyz, gyro_local) from plant ground truth,
    optionally with Gaussian noise drawn from `generator` (a
    torch.Generator; the draws are made on its device and moved to q's)
    — the QMHWSim::parseImu equivalent (reference qm_gazebo/src/
    QMHWSim.cpp:118-171)."""
    R = euler_zyx_to_R(q[3:6])
    quat = R_to_quat(R)
    omega_world = euler_zyx_rate_to_omega_world_matrix(q[3:6]) @ v[3:6]
    gyro_local = R.T @ omega_world
    if generator is not None:
        g, k = [torch.randn(3, generator=generator, dtype=q.dtype,
                            device=generator.device).to(q.device)
                for _ in range(2)]
        quat, gyro_local = apply_imu_noise(quat, gyro_local, g, k,
                                           gyro_sigma, quat_sigma)
    return quat, gyro_local
