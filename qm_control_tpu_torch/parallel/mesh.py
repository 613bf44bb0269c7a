"""Device mesh + sharded scenario batches (port of
qm_control_tpu/parallel/mesh.py).

torch.distributed runs one process (rank) per device where JAX runs one
process over all of a host's devices, so the mesh here is a 1-D
`DeviceMesh` over the world's ranks with the axis name "dp". A scenario
batch is sharded by giving each rank its rows of the leading axis, as a
`DTensor` with placement `Shard(0)` (JAX: `NamedSharding(mesh, P("dp"))`).
Per-scenario solves never communicate: the only collective is one
all-reduce of the fleet's cost sum and count (NCCL across cards, gloo for
ranks that share a card or run on the CPU).

torch.func.vmap does not take DTensors, so every step runs on the plain
local shards (`local_rows`) and wraps its outputs back as `Shard(0)`
DTensors. Their global gather is `gather_rows` (c10d's
all_gather_into_tensor). `DTensor.full_tensor()` computes the same over
NCCL or on the CPU, but not for ranks that share a card: with gloo and
CUDA tensors it segfaults in torch 2.11's functional collectives
(`wait_tensor`; docs/gloo_cuda_collectives.py on an H100), while c10d's
collectives run there.
"""
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard
from torch.utils._pytree import tree_map_only

from .. import resolve_device

DP_AXIS = "dp"


def default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(devices=None, device="cuda") -> DeviceMesh:
    """1-D data-parallel mesh over all ranks of the world (or the global
    ranks listed in `devices`), one device per rank.

    With no process group yet this starts a one-rank group in memory
    (`HashStore`; NCCL on "cuda", the rank's current card, gloo on "cpu"),
    so a single process needs no launcher, as JAX's make_mesh() on one
    chip; otherwise it uses the running group, whatever its backend.
    torch has no single-process mesh over several devices: a mesh wider
    than the world raises; start one rank per device with torchrun and
    call initialize_distributed first."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else torch.cuda.current_device())
        dist.init_process_group(default_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in
                                                        devices]
    if len(ranks) > world:
        raise ValueError(
            f"make_mesh: {len(ranks)} devices asked for, but the world has "
            f"{world} rank(s); torch runs one rank per device: launch one "
            f"process per device (torchrun --nproc-per-node N) and call "
            f"initialize_distributed() before make_mesh")
    if len(set(ranks)) != len(ranks) or not all(0 <= r < world
                                                for r in ranks):
        raise ValueError(f"make_mesh: devices {ranks} are not distinct "
                         f"ranks of a world of {world}")
    return DeviceMesh(dev.type, ranks, mesh_dim_names=(DP_AXIS,))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current card on a "cuda"
    mesh (set by make_mesh or initialize_distributed), else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_rows(mesh: DeviceMesh, a) -> torch.Tensor:
    """This rank's rows of a leaf: the local tensor of a Shard(0) DTensor,
    or the rank's block of the leading axis of a global tensor (which
    every rank holds whole), on the rank's device."""
    if isinstance(a, DTensor):
        if a.device_mesh != mesh or tuple(a.placements) != (Shard(0),):
            raise ValueError(f"a DTensor on {a.device_mesh} with "
                             f"{a.placements}, not Shard(0) on {mesh}")
        return a.to_local()
    n = mesh.size()
    if a.dim() == 0 or a.shape[0] % n:
        raise ValueError(f"a leaf of shape {tuple(a.shape)}: the leading "
                         f"(batch) axis must be divisible by the mesh size "
                         f"{n}")
    b = a.shape[0] // n
    r = mesh.get_local_rank(DP_AXIS)
    return a[r * b:(r + 1) * b].to(mesh_device(mesh))


def local_rows(mesh: DeviceMesh, tree):
    """Every tensor leaf of `tree` as this rank's rows (plain tensors)."""
    return tree_map_only(torch.Tensor, lambda a: _rank_rows(mesh, a), tree)


def from_local_rows(mesh: DeviceMesh, tree):
    """Every tensor leaf of `tree` (this rank's rows) as a Shard(0)
    DTensor on the rank's device; no communication (every rank holds the
    same number of rows)."""
    dev = mesh_device(mesh)
    return tree_map_only(torch.Tensor, lambda a: DTensor.from_local(
        a.to(dev), mesh, [Shard(0)], run_check=False), tree)


def gather_rows(mesh: DeviceMesh, tree):
    """Every Shard(0) DTensor leaf of `tree` gathered whole on every rank
    (one all_gather_into_tensor over the mesh's group per leaf; gloo runs
    it on CUDA tensors too, through the host)."""
    group = mesh.get_group(DP_AXIS)

    def gather(a):
        local = _rank_rows(mesh, a).contiguous()
        out = local.new_empty((mesh.size() * local.shape[0],
                               *local.shape[1:]))
        dist.all_gather_into_tensor(out, local, group=group)
        return out

    return tree_map_only(DTensor, gather, tree)


def shard_scenarios(mesh: DeviceMesh, batch):
    """Place a pytree of batched tensors (BatchScenario, a batched
    CycleCarry, targets, mode schedules; leading dim B divisible by the
    mesh size, the same global values on every rank) with the batch axis
    sharded over the mesh: each leaf becomes a Shard(0) DTensor holding
    this rank's rows."""
    return from_local_rows(mesh, local_rows(mesh, batch))


def fleet_mean(mesh: DeviceMesh, vals: torch.Tensor) -> torch.Tensor:
    """sum(vals) / vals.shape[0], each summed over the mesh's ranks: one
    all-reduce of a 2-vector (JAX: psum of the sum and of the count)."""
    acc = torch.stack([vals.sum(), torch.full(
        (), vals.shape[0], dtype=vals.dtype, device=vals.device)])
    dist.all_reduce(acc, group=mesh.get_group(DP_AXIS))
    return acc[0] / acc[1]


def sharded_mpc_step(mesh: DeviceMesh, batched_step):
    """Wrap a batched MPC step so inputs and outputs stay sharded over the
    mesh and the fleet's mean solver cost is reduced with a collective
    (the only communication in the fleet).

    batched_step: step(batch) -> (batch', policy), e.g.
    parallel.batch.make_batched_mpc_step (vmapped, shard-agnostic).
    Returns run(batch) -> (batch', policy, mean_cost): batch may hold
    Shard(0) DTensors or global tensors; batch' and policy are Shard(0)
    DTensors; mean_cost is a plain 0-d tensor on the rank's device."""
    def run(batch):
        new_batch, policy = batched_step(local_rows(mesh, batch))
        mean_cost = fleet_mean(mesh, policy.cost)
        return (from_local_rows(mesh, new_batch),
                from_local_rows(mesh, policy), mean_cost)

    return run
