"""The robot for the plain reference: the model file, rotations, forward
kinematics, geometric Jacobians, the mass matrix, the bias forces by
recursive Newton-Euler, the centroidal momentum matrix.

Written from the rigid-body textbook (Featherstone, Rigid Body Dynamics
Algorithms; Siciliano et al., Robotics ch. 3 and 7), not from the port.
The model is `robot_aliengo_j2n6s300.json` (the numbers of the reference
robot's URDF). The floating base is 6 virtual joints (prismatic x, y, z,
then revolute z, y, x), so q = [p_base, zyx Euler angles, 18 joints] and
the velocities are the coordinates' rates. Every function takes tensors
with any leading batch shape and works in their dtype and on their device.
"""
import json
import os

import torch

GRAVITY = 9.81
JOINT_NAMES = (
    "LF_HAA", "LF_HFE", "LF_KFE", "LH_HAA", "LH_HFE", "LH_KFE",
    "RF_HAA", "RF_HFE", "RF_KFE", "RH_HAA", "RH_HFE", "RH_KFE",
    "j2n6s300_joint_1", "j2n6s300_joint_2", "j2n6s300_joint_3",
    "j2n6s300_joint_4", "j2n6s300_joint_5", "j2n6s300_joint_6")
FEET = ("LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT")   # contact order
EE = "j2n6s300_end_effector"
# the three joints (of the 18) that move each foot, in contact order
FOOT_JOINTS = ((0, 1, 2), (6, 7, 8), (3, 4, 5), (9, 10, 11))
NOMINAL_JOINTS = (0.0, 0.8, -1.5, 0.0, 0.8, -1.5, 0.0, 0.8, -1.5,
                  0.0, 0.8, -1.5, 3.14, 3.61, 0.86, 2.7, 1.37, -0.4)
MODEL_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "robot_aliengo_j2n6s300.json")


# -- small vector algebra -----------------------------------------------------

def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mv(A, x):
    return (A @ x.unsqueeze(-1)).squeeze(-1)


def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rodrigues(axis, angle):
    """Rotation by `angle` about the unit `axis`."""
    K = skew(axis.expand(angle.shape + (3,)))
    s, c = torch.sin(angle)[..., None, None], torch.cos(angle)[..., None, None]
    eye = torch.eye(3, dtype=angle.dtype, device=angle.device)
    return eye + s * K + (1.0 - c) * (K @ K)


def euler_zyx_to_R(zyx):
    """R = Rz(yaw) Ry(pitch) Rx(roll) for zyx = (yaw, pitch, roll)."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=zyx.dtype, device=zyx.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=zyx.dtype, device=zyx.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=zyx.dtype, device=zyx.device)
    return (rodrigues(ez, zyx[..., 0]) @ rodrigues(ey, zyx[..., 1])
            @ rodrigues(ex, zyx[..., 2]))


def R_to_euler_zyx(R):
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([yaw, pitch, roll], -1)


def euler_rate_matrix(zyx):
    """E with omega_world = E zyx_dot: the columns are the world axes of
    the yaw, pitch and roll rotations."""
    a, b = zyx[..., 0], zyx[..., 1]
    z, o = torch.zeros_like(a), torch.ones_like(a)
    cols = [torch.stack([z, z, o], -1),
            torch.stack([-torch.sin(a), torch.cos(a), z], -1),
            torch.stack([torch.cos(a) * torch.cos(b),
                         torch.sin(a) * torch.cos(b), -torch.sin(b)], -1)]
    return torch.stack(cols, -1)


def quat_to_R(q):
    """Unit or not, (w, x, y, z) -> R."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, v = q[..., :1, None], q[..., 1:]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    vvT = v.unsqueeze(-1) * v.unsqueeze(-2)
    return (w * w - (v * v).sum(-1)[..., None, None]) * eye + 2.0 * vvT \
        + 2.0 * w * skew(v)


def R_to_quat(R):
    """R -> (w, x, y, z) with w >= 0: each candidate from the largest of
    the four diagonal combinations (Shepperd's method)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    k = torch.argmax(torch.stack([tr, 2 * R[..., 0, 0] - tr,
                                  2 * R[..., 1, 1] - tr,
                                  2 * R[..., 2, 2] - tr], -1), -1)
    d21, d02, d10 = (R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1])
    s01, s02, s12 = (R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0],
                     R[..., 1, 2] + R[..., 2, 1])
    cands = []
    for i, (big, a, b, c) in enumerate((
            (1 + tr, d21, d02, d10),
            (1 + 2 * R[..., 0, 0] - tr, d21, s01, s02),
            (1 + 2 * R[..., 1, 1] - tr, d02, s01, s12),
            (1 + 2 * R[..., 2, 2] - tr, d10, s02, s12))):
        r = torch.sqrt(torch.clamp(big, min=1e-30))
        h = 0.5 / r
        if i == 0:
            q = torch.stack([0.5 * r, a * h, b * h, c * h], -1)
        elif i == 1:
            q = torch.stack([a * h, 0.5 * r, b * h, c * h], -1)
        elif i == 2:
            q = torch.stack([a * h, b * h, 0.5 * r, c * h], -1)
        else:
            q = torch.stack([a * h, b * h, c * h, 0.5 * r], -1)
        cands.append(q)
    q = torch.gather(torch.stack(cands, -2), -2,
                     k[..., None, None].expand(k.shape + (1, 4)))[..., 0, :]
    return torch.where(q[..., :1] < 0, -q, q)


def quat_error(q, q_ref):
    """The vector part of the error quaternion between two (w, x, y, z)
    quaternions, the orientation residual of the reference's end-effector
    constraint (OCS2 quaternionDistance): w vr - wr v - v x vr."""
    w, v = q[..., :1], q[..., 1:]
    wr, vr = q_ref[..., :1], q_ref[..., 1:]
    return w * vr - wr * v - cross(v, vr)


def so3_log(R):
    """Rotation vector of R."""
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2,
                    -1.0, 1.0)
    th = torch.arccos(c)
    w = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2],
                           R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s = torch.sin(th)
    small = s < 1e-7
    f = torch.where(small, torch.ones_like(s), th / torch.where(
        small, torch.ones_like(s), s))
    return f[..., None] * w


def slerp(q0, q1, s):
    """Shortest-path spherical interpolation of (w, x, y, z) quaternions,
    s = 0 at q0."""
    d = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    th = torch.arccos(torch.clamp(d.abs(), max=1.0))
    sn = torch.sin(th)
    small = sn < 1e-6
    safe = torch.where(small, torch.ones_like(sn), sn)
    s = torch.as_tensor(s, dtype=q0.dtype, device=q0.device)[..., None]
    w0 = torch.where(small, 1 - s, torch.sin((1 - s) * th) / safe)
    w1 = torch.where(small, s, torch.sin(s * th) / safe)
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# -- the model ----------------------------------------------------------------

class Robot:
    """The kinematic tree of the model file in a dtype, on a device. Body
    i is moved by joint i: 0-5 the virtual base joints (body 5 the base),
    6-23 the 18 joints."""

    def __init__(self, dtype=torch.float64, device="cpu", path=MODEL_FILE):
        with open(path) as fh:
            spec = json.load(fh)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        self.dtype, self.device = dtype, torch.device(device)
        eye = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        units = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        self.parent = [-1, 0, 1, 2, 3, 4]
        self.revolute = [False, False, False, True, True, True]
        axes = units + [units[2], units[1], units[0]]
        Rs, ps = [eye] * 6, [[0.0, 0.0, 0.0]] * 6
        zero3 = [[0.0] * 3] * 3
        mass, com, inertia = [0.0] * 5, [[0.0] * 3] * 5, [zero3] * 5
        root = spec["root"]
        mass.append(root["mass"])
        com.append(root["com"])
        inertia.append(root["inertia"])
        body = {"__root__": 5}
        assert tuple(j["name"] for j in spec["joints"]) == JOINT_NAMES
        lo, hi, effort = [], [], []
        for k, j in enumerate(spec["joints"]):
            body[j["name"]] = 6 + k
            self.parent.append(body[j["parent"]])
            self.revolute.append(j["type"] == "revolute")
            axes.append(j["axis"])
            Rs.append(j["R"])
            ps.append(j["p"])
            mass.append(j["mass"])
            com.append(j["com"])
            inertia.append(j["inertia"])
            lim = j["limit"] or {}
            lo.append(lim.get("lower", -float("inf")))
            hi.append(lim.get("upper", float("inf")))
            effort.append(lim.get("effort", float("inf")))
        self.n = len(self.parent)
        self.axis, self.XR, self.Xp = t(axes), t(Rs), t(ps)
        self.mass, self.com, self.inertia = t(mass), t(com), t(inertia)
        self.joint_lower, self.joint_upper = t(lo), t(hi)
        self.effort = t(effort)
        self.total_mass = float(spec["total_mass"])
        self.frames = {name: (body[f["parent"]], t(f["p"]), t(f["R"]))
                       for name, f in spec["frames"].items()}
        # chain[b]: the joints that move body b (b's ancestors and b)
        self.chain = []
        for b in range(self.n):
            c, k = [], b
            while k >= 0:
                c.append(k)
                k = self.parent[k]
            self.chain.append(set(c))

    def fk(self, q):
        """Per body: world rotation R, origin p, joint axis a and joint
        origin o (lists of n tensors with q's leading shape)."""
        R, p, a, o = [], [], [], []
        shape = q.shape[:-1]
        for i in range(self.n):
            if self.parent[i] < 0:
                Rp = torch.eye(3, dtype=q.dtype, device=q.device).expand(
                    shape + (3, 3))
                pp = torch.zeros(shape + (3,), dtype=q.dtype, device=q.device)
            else:
                Rp, pp = R[self.parent[i]], p[self.parent[i]]
            Ro = Rp @ self.XR[i]
            oi = pp + mv(Rp, self.Xp[i].expand(shape + (3,)))
            ai = mv(Ro, self.axis[i].expand(shape + (3,)))
            if self.revolute[i]:
                R.append(Ro @ rodrigues(self.axis[i], q[..., i]))
                p.append(oi)
            else:
                R.append(Ro)
                p.append(oi + ai * q[..., i, None])
            a.append(ai)
            o.append(oi)
        return dict(R=R, p=p, a=a, o=o)

    def frame(self, kin, name):
        """(position, rotation) of a named frame."""
        b, fp, fR = self.frames[name]
        return kin["p"][b] + mv(kin["R"][b], fp.expand(
            kin["p"][b].shape)), kin["R"][b] @ fR

    def jacobian(self, kin, point, b):
        """(..., 6, n) [linear; angular] Jacobian of a world point fixed
        on body b."""
        cols = []
        zero = torch.zeros_like(point)
        for k in range(self.n):
            if k not in self.chain[b]:
                lin = ang = zero
            elif self.revolute[k]:
                lin, ang = cross(kin["a"][k], point - kin["o"][k]), \
                    kin["a"][k]
            else:
                lin, ang = kin["a"][k], zero
            cols.append(torch.cat([lin, ang], -1))
        return torch.stack(cols, -1)

    def frame_jacobian(self, kin, name):
        pos, _ = self.frame(kin, name)
        return self.jacobian(kin, pos, self.frames[name][0])

    def feet(self, q):
        """(4, 3) foot positions, contact order."""
        kin = self.fk(q)
        return torch.stack([self.frame(kin, f)[0] for f in FEET], -2)

    def coms(self, kin):
        return [kin["p"][b] + mv(kin["R"][b], self.com[b].expand(
            kin["p"][b].shape)) for b in range(self.n)]

    def inertia_world(self, kin, b):
        return kin["R"][b] @ self.inertia[b] @ kin["R"][b].transpose(-1, -2)

    def mass_matrix(self, q, kin=None):
        """M = sum_b m_b Jv_b' Jv_b + Jw_b' I_b Jw_b (Jv of the body's
        centre of mass)."""
        kin = self.fk(q) if kin is None else kin
        M = 0.0
        for b, c in enumerate(self.coms(kin)):
            if float(self.mass[b]) == 0.0:
                continue
            J = self.jacobian(kin, c, b)
            Jv, Jw = J[..., :3, :], J[..., 3:, :]
            M = M + self.mass[b] * Jv.transpose(-1, -2) @ Jv \
                + Jw.transpose(-1, -2) @ self.inertia_world(kin, b) @ Jw
        return M

    def bias(self, q, v, kin=None):
        """h(q, v) = C(q, v) v + g(q): the joint forces that hold the tree
        at zero acceleration, by recursive Newton-Euler (outward: body
        rates and the accelerations of each centre of mass with qdd = 0;
        inward as generalized forces through the Jacobians)."""
        kin = self.fk(q) if kin is None else kin
        R, p, a = kin["R"], kin["p"], kin["a"]
        w, al, acc = [], [], []            # omega, alpha, origin accel
        zero = torch.zeros_like(p[0])
        g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=q.dtype,
                         device=q.device)
        h = 0.0
        coms = self.coms(kin)
        for i in range(self.n):
            par = self.parent[i]
            wp, ap, accp = (zero, zero, zero) if par < 0 else \
                (w[par], al[par], acc[par])
            pp = zero if par < 0 else p[par]
            r = p[i] - pp
            qd = v[..., i, None]
            ai = accp + cross(ap, r) + cross(wp, cross(wp, r))
            if self.revolute[i]:
                wi = wp + a[i] * qd
                ali = ap + cross(wp, a[i]) * qd
            else:
                wi, ali = wp, ap
                ai = ai + 2.0 * cross(wp, a[i]) * qd
            w.append(wi)
            al.append(ali)
            acc.append(ai)
            if float(self.mass[i]) == 0.0:
                continue
            d = coms[i] - p[i]
            ac = ai + cross(ali, d) + cross(wi, cross(wi, d))
            F = self.mass[i] * (ac - g)
            Iw = self.inertia_world(kin, i)
            N = mv(Iw, ali) + cross(wi, mv(Iw, wi))
            J = self.jacobian(kin, coms[i], i)
            h = h + mv(J[..., :3, :].transpose(-1, -2), F) \
                + mv(J[..., 3:, :].transpose(-1, -2), N)
        return h

    def com_position(self, q):
        kin = self.fk(q)
        return sum(self.mass[b] * c for b, c in enumerate(self.coms(kin))) \
            / self.mass.sum()

    def momentum_matrix(self, q):
        """(6, n) A(q): [linear; angular about the centre of mass]
        momentum = A(q) v."""
        kin = self.fk(q)
        coms = self.coms(kin)
        m = self.mass.sum()
        c = sum(self.mass[b] * cb for b, cb in enumerate(coms)) / m
        A = 0.0
        for b, cb in enumerate(coms):
            if float(self.mass[b]) == 0.0:
                continue
            J = self.jacobian(kin, cb, b)
            lin = self.mass[b] * J[..., :3, :]
            ang = skew(cb - c) @ lin + self.inertia_world(kin, b) \
                @ J[..., 3:, :]
            A = A + torch.cat([lin, ang], -2)
        return A


def nominal_q(base_pos, dtype=torch.float64, device="cpu"):
    return torch.tensor(list(base_pos) + [0.0, 0.0, 0.0]
                        + list(NOMINAL_JOINTS), dtype=dtype, device=device)


class Centroidal:
    """The single-rigid-body constants at the nominal configuration (base
    at the origin, level): the mass, the centre of mass and the inertia
    about it, both in the base frame."""

    def __init__(self, robot: Robot):
        q = nominal_q((0.0, 0.0, 0.0), robot.dtype, robot.device)
        self.mass = robot.total_mass
        self.r_com = robot.com_position(q)
        A = robot.momentum_matrix(q)
        E0 = euler_rate_matrix(q[3:6])
        self.I_com = A[3:, 3:6] @ torch.linalg.inv(E0)
