"""Rotation utilities (port of qm_control_tpu/models/rotations.py).

Conventions as in the JAX module: base orientation is ZYX Euler angles
(yaw z, pitch y, roll x), quaternions are (w, x, y, z), and velocity
coordinates are Euler rates mapped to world angular velocity by
`euler_zyx_rate_to_omega_world_matrix`. Every function is branch-free and
broadcasts over leading dims, so it runs under torch.func transforms.
"""
import math

import torch


def _stack_rows(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def skew(v):
    """3-vector -> skew-symmetric S(v) with S(v) @ u = v x u."""
    z = torch.zeros_like(v[..., 0])
    return _stack_rows([[z, -v[..., 2], v[..., 1]],
                        [v[..., 2], z, -v[..., 0]],
                        [-v[..., 1], v[..., 0], z]])


def unskew(S):
    return torch.stack([S[..., 2, 1], S[..., 0, 2], S[..., 1, 0]], dim=-1)


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    return _stack_rows([[c, -s, z], [s, c, z], [z, z, o]])


def axis_angle_to_R(axis, angle):
    """Rodrigues formula for unit axes, written out elementwise."""
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    s = torch.sin(angle)
    c = torch.cos(angle)
    C = 1.0 - c
    return _stack_rows([
        [c + C * ax * ax, C * ax * ay - s * az, C * ax * az + s * ay],
        [C * ay * ax + s * az, c + C * ay * ay, C * ay * az - s * ax],
        [C * az * ax - s * ay, C * az * ay + s * ax, c + C * az * az]])


def euler_zyx_to_R(zyx):
    """zyx = (yaw, pitch, roll) -> R = Rz(yaw) Ry(pitch) Rx(roll)."""
    cz, sz = torch.cos(zyx[..., 0]), torch.sin(zyx[..., 0])
    cy, sy = torch.cos(zyx[..., 1]), torch.sin(zyx[..., 1])
    cx, sx = torch.cos(zyx[..., 2]), torch.sin(zyx[..., 2])
    return _stack_rows([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx]])


def R_to_euler_zyx(R):
    """Inverse of euler_zyx_to_R (pitch in (-pi/2, pi/2))."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.atan2(-R[..., 2, 0],
                        torch.sqrt(R[..., 2, 1] ** 2 + R[..., 2, 2] ** 2))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], dim=-1)


def euler_zyx_rate_to_omega_world_matrix(zyx):
    """E(zyx) with omega_world = E @ zyx_dot (zyx_dot ordered yaw,pitch,roll)."""
    a, b = zyx[..., 0], zyx[..., 1]
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    z = torch.zeros_like(a)
    o = torch.ones_like(a)
    return _stack_rows([[z, -sa, ca * cb],
                        [z, ca, sa * cb],
                        [o, z, -sb]])


def omega_world_to_euler_zyx_rate_matrix(zyx):
    from .smallmat import inv3
    return inv3(euler_zyx_rate_to_omega_world_matrix(zyx))


def quat_to_R(q):
    """(w,x,y,z) quaternion -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = w * w + x * x + y * y + z * z
    s = 2.0 / n
    return _stack_rows([
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)]])


def R_to_quat(R):
    """Rotation matrix -> (w,x,y,z) quaternion, branch-free, w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1 + tr, min=1e-12)) / 2
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], -1)
    qx1 = torch.sqrt(torch.clamp(1 + m00 - m11 - m22, min=1e-12)) / 2
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], -1)
    qy2 = torch.sqrt(torch.clamp(1 - m00 + m11 - m22, min=1e-12)) / 2
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], -1)
    qz3 = torch.sqrt(torch.clamp(1 - m00 - m11 + m22, min=1e-12)) / 2
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], -1)
    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(cond0[..., None], q0,
                    torch.where(cond1[..., None], q1,
                                torch.where(cond2[..., None], q2, q3)))
    w = q[..., :1]
    return q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))


def quat_mul(a, b):
    w1, x1, y1, z1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    w2, x2, y2, z2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_slerp(q0, q1, t):
    """Spherical interpolation, shortest path, branch-free (Eigen's
    Quaternion::slerp, reference EndEffectorConstraint.cpp:102)."""
    d = torch.sum(q0 * q1, dim=-1)
    q1 = torch.where(d[..., None] < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(small, t * torch.ones_like(theta),
                     torch.sin(t * theta) / safe_sin)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_distance(q, q_ref):
    """OCS2 quaternionDistance: the vector part of the error quaternion,
    q.w q_ref.vec - q_ref.w q.vec - q.vec x q_ref.vec; zero iff q = +-q_ref
    (reference EndEffectorConstraint.cpp:55-77)."""
    w, v = q[..., 0], q[..., 1:]
    wr, vr = q_ref[..., 0], q_ref[..., 1:]
    return w[..., None] * vr - wr[..., None] * v \
        - torch.linalg.cross(v, vr, dim=-1)


def so3_log(R):
    """Matrix log of a rotation -> axis-angle vector (rotation error)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = unskew(R - R.transpose(-1, -2)) / 2.0      # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-7
    one = torch.ones_like(sin_theta)
    scale = torch.where(small, one, theta / torch.where(small, one, sin_theta))
    return scale[..., None] * w


def rotation_error_world(R_des, R_meas):
    """World-frame rotation error e with R_des ~ exp(S(e)) R_meas
    (reference WbcBase.cpp:283, :516)."""
    return so3_log(R_des @ R_meas.transpose(-1, -2))


def yaw_unwrap(yaw, last_yaw):
    """Shift yaw by multiples of 2*pi to stay near last_yaw
    (reference QMController.cpp:239-242)."""
    return yaw + 2.0 * math.pi * torch.round((last_yaw - yaw) / (2.0 * math.pi))
