"""PyTorch port vs JAX reference: multi-process scale-out
(parallel/distributed.py), the port's counterpart of
tests/test_multiprocess.py, not slow-marked.

Two gloo processes on the CPU over localhost (each a child of this test,
one rank each, a free port, a time limit) run:
  * host_local_batch_to_global + sharded_mean of 2x over arange(8), each
    rank holding 4: 7.0 within 1e-5 (JAX's bound);
  * shard_scenarios of a batch of 3 over 2 ranks: raises;
  * sharded_fleet_step on a 4-scenario batch (2 per rank), the batch of
    tests/test_torch_mesh.py at JAX's horizon (0.12 s / 0.04 s, 1 SQP
    iteration), the gathered cost, X and W against JAX's
    make_batched_mpc_step on the same numpy inputs by
    tests/test_torch_parallel.py's tolerances (cost 1e-3 relative, X 2e-3,
    W 0.5 N, the same alpha); both ranks gather the same rows and reduce
    the same mean_cost, within rtol 1e-5 of the gathered costs' mean;
  * sharded_dryrun_cycle (JAX's dryrun_multichip cycle): torques finite.
Also the --probe CLI under torchrun with two CPU ranks, a one-rank
initialize_distributed in this process, the order in which it picks a
rank's card (local_device_ids, then device="cuda:N", then LOCAL_RANK; an
index of the device that disagrees raises), and the device rule: no
entry point runs on the CPU unless asked.
"""
import os
import re
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh import seeded_batches
from test_torch_parallel import _cfgs, _close

from qm_control_tpu_torch.parallel import make_mesh
from qm_control_tpu_torch.parallel.distributed import (_rank_card,
                                                       global_mesh,
                                                       initialize_distributed,
                                                       sharded_mean)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120

_CHILD = r'''
import sys, time
t0 = time.perf_counter()
rank, port, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
import numpy as np
import torch
torch.set_num_threads(1)
from qm_control_tpu_torch.config import MpcConfig, QmConfig
from qm_control_tpu_torch.interop import batch_scenario_from_numpy
from qm_control_tpu_torch.models import centroidal as C
from qm_control_tpu_torch.models import load_model
from qm_control_tpu_torch.parallel import make_batched_mpc_step
from qm_control_tpu_torch.parallel.distributed import (
    global_mesh, host_local_batch_to_global, initialize_distributed,
    sharded_dryrun_cycle, sharded_fleet_step, sharded_mean)
from qm_control_tpu_torch.parallel.mesh import gather_rows, shard_scenarios
initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                       num_processes=2, process_id=rank, device="cpu")
mesh = global_mesh(device="cpu")
assert mesh.size() == 2 and torch.distributed.get_backend() == "gloo"

local = np.arange(4, dtype=np.float32) + 4 * rank
mean = float(sharded_mean(mesh, lambda x: x * 2.0)(
    host_local_batch_to_global(mesh, local)))
assert abs(mean - 7.0) < 1e-5, mean
refused = False
try:
    shard_scenarios(mesh, torch.zeros(3, 2))
except ValueError:
    refused = True
assert refused, "a batch of 3 over 2 ranks was not refused"

cfg = QmConfig().with_(mpc=MpcConfig(time_horizon=0.12, dt=0.04,
                                     num_iterations=1))
model = load_model()
info = C.make_centroidal_info(model)
leaves = np.load(inputs)
n = leaves["t"].shape[0] // 2
mine = [leaves[k][rank * n:(rank + 1) * n] for k in
        ("t", "x", "times", "states", "event_times", "modes", "W", "X")]
batch = host_local_batch_to_global(
    mesh, batch_scenario_from_numpy(*mine, device="cpu"))
step = sharded_fleet_step(mesh, make_batched_mpc_step(model, info, cfg))
_, policy, mean_cost = step(batch)
full = gather_rows(mesh, policy)
np.savez(out, mean_cost=float(mean_cost),
         **{k: getattr(full, k).numpy() for k in ("cost", "X", "W", "alpha")})
_, _, _, res = sharded_dryrun_cycle(mesh, model, info, cfg)(batch)
tau = gather_rows(mesh, res.torques)
assert tau.shape == (2 * n, 18) and bool(torch.isfinite(tau).all()), tau
torch.distributed.destroy_process_group()
print(f"rank {rank} OK in {time.perf_counter() - t0:.1f} s")
'''


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _child_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK")}
    env.update(PYTHONPATH=ROOT, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    return env


def test_two_process_fleet_matches_jax(model, tmp_path):
    from qm_control_tpu.models import centroidal as JC
    from qm_control_tpu.parallel.batch import make_batched_mpc_step as jmake
    jcfg, _ = _cfgs(0.12, 0.04, settle=True)
    jb, _ = seeded_batches(4, jcfg, seed=2)
    inputs = tmp_path / "batch.npz"
    np.savez(inputs, t=jb.t, x=jb.x, times=jb.target.times,
             states=jb.target.states, event_times=jb.ms.event_times,
             modes=jb.ms.modes, W=jb.W_warm, X=jb.X_warm)
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(inputs),
         str(outs[r])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=_child_env(), cwd=ROOT, text=True) for r in range(2)]
    try:
        # JAX's batched step on the same batch while the ranks run
        _, jp = jax.jit(jmake(model, JC.make_centroidal_info(model),
                              jcfg))(jb)
        logs = [p.communicate(timeout=CHILD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
        assert f"rank {r} OK" in log, log[-2000:]
    got = [np.load(o) for o in outs]
    for k in ("cost", "X", "W", "alpha", "mean_cost"):
        np.testing.assert_array_equal(got[0][k], got[1][k])
    full = SimpleNamespace(**{k: torch.from_numpy(got[0][k])
                              for k in ("cost", "X", "W", "alpha")})
    for i in range(4):
        _close(jp, full, i)
    np.testing.assert_allclose(float(got[0]["mean_cost"]),
                               got[0]["cost"].mean(), rtol=1e-5)


def test_probe_cli_under_torchrun():
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "qm_control_tpu_torch.parallel.distributed",
         "--probe", "--device", "cpu"], cwd=ROOT, env=_child_env(),
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for r in range(2):
        assert f"rank {r}/2 on cpu, backend gloo, mesh dp=2" in out, out
    means = re.findall(r"all-reduce mean = (\S+) \(expect 1\.5\)", out)
    assert len(means) == 2 and all(abs(float(m) - 1.5) < 1e-5
                                   for m in means), out


def test_initialize_distributed_one_rank_in_process(monkeypatch):
    """torchrun's variables set by hand for a world of one; the call is
    idempotent and the group is torn down after."""
    assert not dist.is_initialized(), "a process group outlived its test"
    for k, v in (("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port())), ("WORLD_SIZE", "1"),
                 ("RANK", "0")):
        monkeypatch.setenv(k, v)
    try:
        initialize_distributed(device="cpu")
        group = dist.group.WORLD
        initialize_distributed(device="cpu")
        assert dist.group.WORLD is group and dist.get_backend() == "gloo"
        mesh = global_mesh(device="cpu")
        val = sharded_mean(mesh, lambda x: x)(torch.arange(2.0))
        assert abs(float(val) - 0.5) < 1e-5
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_distributed_without_environment_does_nothing(
        monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="name all three"):
        initialize_distributed(coordinator_address="127.0.0.1:1",
                               device="cpu")
    assert not dist.is_initialized()


def test_entry_points_need_a_gpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        make_mesh()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        global_mesh()
    with pytest.raises(RuntimeError, match="device='cuda'"):
        initialize_distributed(coordinator_address="127.0.0.1:1",
                               num_processes=1, process_id=0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("ids, device, local_rank, card", [
    (None, "cuda", "1", 1),           # torchrun's LOCAL_RANK
    (None, "cuda:1", None, 1),        # the device's index
    (None, "cuda:1", "1", 1),
    (0, "cuda", "1", 0),              # ranks that share card 0
    ([2], "cuda:2", "0", 2),
    (None, "cuda:0", "1", ValueError),   # a named card is never swapped
    (1, "cuda:0", None, ValueError),
    (None, "cuda", None, ValueError),    # no card named at all
    ([0, 1], "cuda", None, ValueError),  # one rank per device
])
def test_rank_card_order(monkeypatch, ids, device, local_rank, card):
    """local_device_ids outranks LOCAL_RANK; an explicit "cuda:N" must
    agree with whichever of them is given. No card is needed: the rule
    only picks the index that torch.cuda.set_device gets."""
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    if card is ValueError:
        with pytest.raises(ValueError):
            _rank_card(ids, torch.device(device), os.environ)
    else:
        assert _rank_card(ids, torch.device(device), os.environ) == card
