"""The plain reference that decides `correct`: the reference controller's
semantics written out in plain PyTorch (robot.py the rigid-body model,
mpc.py the MPC, wbc.py the whole-body controller, hardware.py the
simulated robot, the estimator and the control tick). It imports nothing
of the port and takes nothing the port made: the benchmark hands it the
same inputs (traffic.py) as the port. It runs in float64 on the CPU; the
control runs the same code in float32 with TF32 products on the card.
"""
import torch

from .robot import Centroidal, Robot


def model(dtype=torch.float64, device="cpu"):
    """(Robot, Centroidal) in `dtype` on `device`."""
    robot = Robot(dtype, device)
    return robot, Centroidal(robot)


def check_config(cfg):
    """Refuse a configuration whose settings the reference does not
    implement: one SQP iteration, the arm settled from the first tick."""
    if cfg["mpc"].get("num_iterations", 1) != 1:
        raise ValueError("the reference runs one SQP iteration")
    if cfg["wbc"].get("arm_settling_time", 10.0) != 0.0:
        raise ValueError("the reference's WBC has the settled stack only "
                         "(arm_settling_time 0)")
