"""Multi-process initialization and explicit-collective scale-out (port of
qm_control_tpu/parallel/distributed.py).

torch.distributed runs one process (rank) per device: NCCL between
cards, gloo on the CPU or for ranks that share one card (NCCL refuses two
ranks on one GPU in a communicator). The scenario fleet is pure data
parallelism: per-scenario MPC+WBC solves never communicate; the only
collective traffic is the scalar metric all-reduce.

Run one process per device with torchrun, which sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK:

    torchrun --nproc-per-node N -m qm_control_tpu_torch.parallel.distributed \
        --probe [--device cpu]

or name the coordinator and the ranks yourself (--coordinator HOST:PORT
--num-processes N --process-id I). tests/test_torch_distributed.py runs
two gloo processes on the CPU over localhost.
"""
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap
from torch.utils._pytree import tree_map_only

from .. import resolve_device
from ..gaits.gait import contact_flags_from_mode
from ..mpc.mpc import evaluate_policy
from .batch import make_batched_mpc_step, make_batched_wbc
from .mesh import (DP_AXIS, default_backend, fleet_mean, from_local_rows,
                   local_rows, make_mesh, mesh_device, sharded_mpc_step)


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None, local_device_ids=None,
                           backend=None, device="cuda"):
    """Idempotent torch.distributed.init_process_group wrapper.

    Arguments default to torchrun's environment: MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE, RANK (JAX reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID). Single-process runs (everything None and no
    environment) do nothing; make_mesh then starts a one-rank group.

    On device="cuda" the rank is bound to one card with
    torch.cuda.set_device: `local_device_ids` (an index, or a sequence of
    one: torch runs one rank per device), else the index of `device`
    ("cuda:N"), else LOCAL_RANK (_rank_card). The backend is NCCL on
    the card and gloo on the CPU unless named: "gloo" with device="cuda"
    is how ranks that share a card communicate. Nothing is switched on
    failure: an error of the backend surfaces."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return                      # single process: nothing to do
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            f"initialize_distributed: coordinator {coordinator_address!r}, "
            f"{num_processes} processes, process id {process_id}: name all "
            f"three (or run under torchrun)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_card(local_device_ids, dev, env))
    dist.init_process_group(backend or default_backend(dev),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def _rank_card(local_device_ids, dev, env):
    """This rank's card: `local_device_ids`, else the index of `dev`, else
    LOCAL_RANK. local_device_ids outranks LOCAL_RANK (ranks that share a
    card name it so under torchrun); an index of `dev` that disagrees with
    either raises: a card that the caller named is never swapped."""
    card = _one_id(local_device_ids)
    given = (("local_device_ids", card) if card is not None else
             ("LOCAL_RANK", env.get("LOCAL_RANK")))
    if dev.index is not None:
        if given[1] is not None and int(given[1]) != dev.index:
            raise ValueError(f"initialize_distributed: device {dev} but "
                             f"{given[0]} {given[1]}")
        return dev.index
    if given[1] is None:
        raise ValueError("initialize_distributed: name this rank's card "
                         "(local_device_ids, device='cuda:N' or LOCAL_RANK)")
    return int(given[1])


def _one_id(ids):
    """An index, or a sequence of one (torch runs one rank per device)."""
    if isinstance(ids, (list, tuple)):
        if len(ids) != 1:
            raise ValueError(f"local_device_ids {list(ids)}: torch runs one "
                             f"rank per device; start one process per card")
        return ids[0]
    return ids


def global_mesh(device="cuda"):
    """1-D DP mesh over ALL ranks of the world (every rank calls this)."""
    return make_mesh(device=device)


def host_local_batch_to_global(mesh, local_batch):
    """Assemble a globally sharded pytree from per-process local shards:
    each rank passes its own scenarios (leading dim B_global / ranks, the
    same on every rank; tensors or numpy arrays); the result is one
    Shard(0) DTensor per leaf on the rank's device (JAX:
    make_array_from_process_local_data)."""
    return from_local_rows(mesh, tree_map_only(np.ndarray, torch.as_tensor,
                                               local_batch))


def sharded_mean(mesh, fn):
    """fn vmapped over this rank's shard, then an explicit all-reduce:
    out = sum over ranks of sum(fn(shard)) / B_global (JAX: shard_map +
    psum). Returns g(batch) -> 0-d tensor; batch holds Shard(0) DTensors
    or global tensors."""
    vfn = vmap(fn)
    return lambda batch: fleet_mean(mesh, vfn(local_rows(mesh, batch)))


def sharded_fleet_step(mesh, batched_step):
    """Globally sharded MPC fleet step with the explicitly all-reduced cost
    mean (JAX's multi-host variant of mesh.sharded_mpc_step; in torch the
    two are the same: each rank steps its shard, one all-reduce).
    Returns run(batch) -> (batch', policy, mean_cost)."""
    return sharded_mpc_step(mesh, batched_step)


def dryrun_wbc_args(policy, x):
    """The batched WBC's arguments in the JAX package's multichip dry run
    (__graft_entry__.py:dryrun_multichip), on plain rows: each policy
    evaluated at t = 0.01, the contact flags of its mode, the joints of
    `x` at zero velocity, period 0.002, time 20. Returns the argument
    tuple of make_batched_wbc's wbc."""
    dev = x.device
    x_des, u_des, modes = vmap(evaluate_policy, in_dims=(0, None))(
        policy, torch.tensor(0.01, device=dev))
    flags = vmap(contact_flags_from_mode)(modes).to(torch.float32)
    q = x[:, 6:30]
    return (x_des, u_des, u_des, q, torch.zeros_like(q), flags,
            torch.tensor(0.002, device=dev), torch.tensor(20.0, device=dev))


def sharded_dryrun_cycle(mesh, model, info, cfg):
    """The MPC+WBC cycle of the JAX package's multichip dry run on a mesh:
    the sharded MPC fleet step (make_batched_mpc_step's defaults), then on
    each rank's shard the batched WBC (make_batched_wbc(cascade="fused"),
    default gains: one K1 launch of B_local blocks per rank on the card)
    on dryrun_wbc_args of its policies.

    Returns run(batch) -> (batch', policy, mean_cost, wbc): batch',
    policy and the WbcResult wbc are Shard(0) DTensors."""
    step = sharded_fleet_step(mesh, make_batched_mpc_step(model, info, cfg))
    wbc = make_batched_wbc(model, info, cascade="fused",
                           device=mesh_device(mesh))

    def run(batch):
        new_batch, policy, mean_cost = step(batch)
        res = wbc(*dryrun_wbc_args(*local_rows(mesh, (policy, new_batch.x))))
        return new_batch, policy, mean_cost, from_local_rows(mesh, res)

    return run


def _probe(device="cuda", **init):
    """Print the rank topology and run one all-reduce (sanity)."""
    initialize_distributed(device=device, **init)
    mesh = global_mesh(device=device)
    n = mesh.size()
    print(f"rank {dist.get_rank()}/{dist.get_world_size()} on "
          f"{mesh_device(mesh)}, backend {dist.get_backend()}, mesh "
          f"{DP_AXIS}={n}")
    val = float(sharded_mean(mesh, lambda x: x)(
        torch.arange(2 * n, dtype=torch.float32)))
    expect = (2 * n - 1) / 2.0
    print(f"all-reduce mean = {val} (expect {expect})")
    if not abs(val - expect) < 1e-5:
        raise AssertionError(f"all-reduce mean {val} != {expect}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.probe:
        try:
            _probe(args.device, coordinator_address=args.coordinator,
                   num_processes=args.num_processes,
                   process_id=args.process_id, backend=args.backend)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
