"""Hardware abstraction seam (port of qm_control_tpu/runtime/hw.py): the
boundary a real robot plugs into (reference hardware_interface::RobotHW +
HybridJointInterface + ContactSensorInterface + ImuSensorInterface,
consumed by QMController::init, QMController.cpp:60-126).

    HardwareInterface (protocol)
      read()  -> HWReading   (joint encoders, IMU, contact flags)
      write(HybridCommand)   (per-joint 5-tuple: pos, vel, kp, kd, tau)

    SimHardware  — the in-repo plant behind the seam, on the device (the
                   reference's QMHWSim role)
    HardwareLoop — the host loop of QMController::update: IMU estimator
                   -> MPC (inline, or on the asynchronous MRT worker)
                   -> WBC -> hybrid commands, paced by the caller's clock
                   or by the native RatePacer

A physical robot integrates by implementing HardwareInterface over its
EtherCAT, CAN or ROS stack; everything above the seam is unchanged. The
WBC is the port's HierarchicalWbc, whose cascade is K1: one K1 launch
per tick, from the thread that calls tick(); the MPC worker launches
none.
"""
import contextlib
from typing import NamedTuple, Protocol

import torch
from torch.profiler import record_function

from .. import resolve_device
from ..config import QmConfig
from ..gaits.gait import contact_flags_from_mode
from ..models import kinematics as K
from ..models.spec import RobotModel
from ..utils.graphs import GraphRunner
from .estimator import (ImuEstimatorState, imu_estimator_update,
                        imu_from_plant, init_imu_estimator,
                        observation_from_rbd, rbd_to_qv)
from .plant import (STEP_SPAN, HybridCommand, PlantConfig, PlantState,
                    init_plant_state, make_plant_step, plant_write)


class HWReading(NamedTuple):
    """One sensor sweep (reference: the hardware_interface handles read
    in QMController::update)."""
    joint_pos: torch.Tensor      # (18,) encoder positions
    joint_vel: torch.Tensor      # (18,)
    imu_quat_wxyz: torch.Tensor  # (4,) orientation
    imu_gyro: torch.Tensor       # (3,) base-frame angular rate
    imu_acc: torch.Tensor        # (3,) base-frame linear acceleration
    contact_flags: torch.Tensor  # (4,) float foot contacts
    stamp: float                 # seconds


class HardwareInterface(Protocol):
    """What a robot (or sim) must provide."""

    def read(self) -> HWReading: ...

    def write(self, cmd: HybridCommand) -> None: ...


class SimHardware:
    """The in-repo plant behind the hardware seam, kept on `device`.

    Steps `substeps` physics ticks per write (the plant integrates at
    1 kHz while the controller writes at 500 Hz, like Gazebo vs
    ros_control). Contact flags come from the plant's normal forces (the
    ContactSensorInterface role), the IMU from the plant state.
    `imu_noise` is a torch.Generator passed to imu_from_plant without
    sigmas, as the JAX package passes its key, so it draws but adds no
    noise (ROADMAP Queue 3). A write is plant.plant_write through the
    graph runner "plant" (utils/graphs.py): on the card its substeps
    replay as CUDA graphs, one per substep, from the second write on."""

    def __init__(self, model: RobotModel, q0, cfg: PlantConfig = PlantConfig(),
                 substeps: int = 2, imu_noise=None, device="cuda"):
        self.model = model
        self.state: PlantState = init_plant_state(q0, model=model,
                                                  device=resolve_device(device))
        self._step = make_plant_step(model, cfg)
        self._write = GraphRunner(plant_write, "plant", first=STEP_SPAN)
        self.substeps = substeps
        self.imu_noise = imu_noise
        self._t = 0.0
        self._dt = cfg.sim_dt
        # measured contact: a quarter of the weight per foot
        self._fz_min = 0.25 * 9.81 * model.total_mass / 4

    def read(self) -> HWReading:
        q, v = self.state.q, self.state.v
        quat, gyro = imu_from_plant(self.model, q, v, generator=self.imu_noise)
        flags = (self._contact_normal_forces() > self._fz_min).to(
            torch.float32)
        return HWReading(joint_pos=q[6:24], joint_vel=v[6:24],
                         imu_quat_wxyz=quat, imu_gyro=gyro,
                         imu_acc=torch.zeros_like(q[:3]),  # not estimated
                         contact_flags=flags, stamp=self._t)

    def _contact_normal_forces(self):
        p = K.contact_positions(self.model, self.state.q)
        return 40000.0 * torch.clamp(-p[:, 2], min=0.0)  # PlantConfig.contact_kp

    def write(self, cmd: HybridCommand) -> None:
        self.state = self._write(self._step, self.state, cmd, self.substeps)
        self._t += self.substeps * self._dt


# the record_function range of a tick's sensor read and IMU estimator
ESTIMATE_SPAN = "hw.estimate"


class HardwareLoop:
    """Host-paced controller against a HardwareInterface: the
    QMController::update flow for real hardware. The caller owns the
    clock (call `tick()` at control_freq, or `run_paced()` for a
    wall-clock-paced loop with overrun accounting).

    MPC placement (reference QMController.cpp:309-334): with
    `async_mpc=True` (default) solves run on the runtime.mrt worker
    thread paced to mpc_freq, exchanging the policy through the native
    seqlock buffer; `async_mpc=False` solves inline on every
    ticks_per_mpc-th tick (deterministic, single thread).

    In the asynchronous mode on the card each tick runs on a stream of
    the loop's own, ordered after the caller's current stream, which in
    turn waits for the tick. Beside a worker that replays the solve's
    CUDA graphs, launches onto the legacy default stream stall (a tick
    took ~10 s instead of ~0.34 s on an H100; the cause is not known), so
    the tick keeps off that stream whatever stream its caller is on."""

    def __init__(self, model: RobotModel, info, cfg: QmConfig, hw,
                 control_freq: float = 500.0, mpc_freq: float = 100.0,
                 async_mpc: bool = True, device="cuda"):
        from ..mpc.mpc import MpcSolver, evaluate_policy
        from ..wbc.wbc import HierarchicalWbc
        self.device = dev = resolve_device(device)
        self.model, self.info, self.cfg, self.hw = model, info, cfg, hw
        self.solver = MpcSolver(model, info, cfg, device=dev)
        self.wbc = HierarchicalWbc(model, info, cfg.wbc, device=dev)
        self._eval = evaluate_policy
        self.est: ImuEstimatorState = init_imu_estimator(device=dev)
        self.ticks_per_mpc = int(round(control_freq / mpc_freq))
        self.control_freq = control_freq
        self.tick_dt = 1.0 / control_freq
        self.policy = None
        self.t = 0.0
        self._k = 0
        self.async_mpc = async_mpc
        self.mrt = None
        self._stream = None
        if async_mpc:
            from .mrt import MpcMrtInterface
            self.mrt = MpcMrtInterface(self.solver, mpc_frequency=mpc_freq)
            if dev.type == "cuda":
                self._stream = torch.cuda.Stream(device=dev)
        g, f32 = cfg.wbc, dict(dtype=torch.float32, device=dev)
        self._kp = torch.cat([torch.zeros(12, **f32),
                              torch.full((6,), g.kp_arm_wbc, **f32)])
        self._kd = torch.cat([torch.full((12,), 3.0, **f32),
                              torch.full((6,), g.kd_arm_wbc, **f32)])
        self._zeros6 = torch.zeros(6, **f32)

    def _estimate(self, r: HWReading, base_pos_hint, base_vel_hint):
        rbd, _, self.est = imu_estimator_update(
            self.model, self.est, r.imu_quat_wxyz, r.imu_gyro, r.joint_pos,
            r.joint_vel, base_pos_hint, base_vel_hint, r.contact_flags)
        return rbd, observation_from_rbd(self.model, self.info, rbd)

    def start(self, target, mode_schedule, base_pos_hint, base_vel_hint,
              timeout: float = 300.0):
        """The reference's starting() handshake (QMController.cpp:98-126):
        publish the first observation and block until the worker delivers
        the initial policy. No-op in inline mode."""
        if not self.async_mpc:
            return
        import time
        _, x_obs = self._estimate(self.hw.read(), base_pos_hint,
                                  base_vel_hint)
        self.mrt.set_current_observation(self.t, x_obs, target,
                                         mode_schedule)
        self.mrt.start()
        deadline = time.perf_counter() + timeout
        while not self.mrt.initial_policy_received():
            if self.mrt._error is not None:
                self.mrt.stop()            # re-raises the worker's error
            if time.perf_counter() > deadline:
                raise TimeoutError(f"no initial MPC policy within "
                                   f"{timeout}s")
            time.sleep(0.002)

    def stop(self):
        if self.mrt is not None:
            self.mrt.stop()

    def run_paced(self, num_ticks, target, mode_schedule, base_pos_fn,
                  base_vel_fn):
        """Drive tick() against the wall clock at control_freq with the
        native RatePacer (absolute deadlines); returns the overrun count,
        the real-time health metric the reference reads off its
        RepeatedTimer maxima (QMController.cpp:342-355). Raises when the
        native library cannot be built or loaded.

        base_pos_fn / base_vel_fn: callables () -> (3,) hints (odometry)."""
        from .. import native
        pacer = native.RatePacer(self.control_freq)
        for _ in range(num_ticks):
            self.tick(target, mode_schedule, base_pos_fn(), base_vel_fn())
            pacer.sleep()
        return pacer.overruns

    @contextlib.contextmanager
    def _own_stream(self):
        """The block on the loop's stream, between two waits on the
        caller's (the class docstring); a no-op without that stream."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            caller.wait_stream(self._stream)

    def tick(self, target, mode_schedule, base_pos_hint, base_vel_hint):
        """One control tick: read -> estimate -> (MPC) -> WBC -> write.
        The base position / velocity hints stand in for the leg-odometry
        fusion a full estimator would provide. The estimator, the solve,
        the policy evaluation, the WBC data, the cascade and the plant
        substeps each run inside a named record_function range (the
        modules' *_SPAN constants), which a torch.profiler trace shows."""
        with self._own_stream():
            return self._tick(target, mode_schedule, base_pos_hint,
                              base_vel_hint)

    def _tick(self, target, mode_schedule, base_pos_hint, base_vel_hint):
        with record_function(ESTIMATE_SPAN):
            rbd, x_obs = self._estimate(self.hw.read(), base_pos_hint,
                                        base_vel_hint)
        dev = self.device
        if self.async_mpc:
            # publish the observation; read the newest policy (never
            # blocks on the worker: seqlock buffer)
            self.mrt.set_current_observation(self.t, x_obs, target,
                                             mode_schedule)
            x_des_np, u_des_np, mode = self.mrt.evaluate(self.t, x_obs)
            x_des = torch.as_tensor(x_des_np, device=dev)
            u_des = torch.as_tensor(u_des_np, device=dev)
        else:
            if self.policy is None or self._k % self.ticks_per_mpc == 0:
                self.policy = self.solver.solve(self.t, x_obs, target,
                                                mode_schedule)
            x_des, u_des, mode = self._eval(self.policy, self.t)
        flags = contact_flags_from_mode(mode).to(device=dev,
                                                 dtype=torch.float32)
        q_meas, v_meas = rbd_to_qv(rbd)
        res = self.wbc.update(x_des, u_des, q_meas, v_meas, flags,
                              self.tick_dt, self.t)
        cmd = HybridCommand(
            pos_des=x_des[12:30].to(torch.float32),
            vel_des=torch.cat([u_des[12:24].to(torch.float32),
                               self._zeros6]),
            kp=self._kp, kd=self._kd, ff=res.torques.to(torch.float32))
        self.hw.write(cmd)
        self.t += self.tick_dt
        self._k += 1
        return res, x_obs
