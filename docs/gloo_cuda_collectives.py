"""Which collectives gloo runs on CUDA tensors for two ranks on one card.

    python3 docs/gloo_cuda_collectives.py

Needs one CUDA device. For each operation it starts a fresh pair of
processes (gloo over localhost, both on cuda:0, Python's faulthandler on,
60 s each) and prints their exit codes and output. The port's scale-out
(qm_control_tpu_torch/parallel/mesh.py) gathers with c10d's
all_gather_into_tensor because of what this prints: on an H100 with
torch 2.11 every c10d collective below returns the right values, while
DTensor.full_tensor() on a "cuda" mesh crashes both ranks with a
segmentation fault in the functional collectives' wait_tensor (the same
call on a "cpu" mesh runs).
"""
import faulthandler
import os
import socket
import subprocess
import sys
import time

OPS = ("allreduce_cpu", "allreduce_cuda", "broadcast_cuda",
       "allgather_list_cuda", "allgather_into_cuda", "full_tensor_cuda",
       "full_tensor_cpu_mesh", "barrier")


def child(op, rank, port):
    faulthandler.enable()
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    mine = torch.full((2,), float(rank), device=dev)
    if op == "allreduce_cpu":
        out = mine.cpu()
        dist.all_reduce(out)
    elif op == "allreduce_cuda":
        out = mine.clone()
        dist.all_reduce(out)
    elif op == "broadcast_cuda":
        out = mine.clone()
        dist.broadcast(out, 0)
    elif op == "allgather_list_cuda":
        parts = [torch.empty(2, device=dev) for _ in range(2)]
        dist.all_gather(parts, mine)
        out = torch.cat(parts)
    elif op == "allgather_into_cuda":
        out = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(out, mine)
    elif op in ("full_tensor_cuda", "full_tensor_cpu_mesh"):
        on_card = op == "full_tensor_cuda"
        mesh = DeviceMesh("cuda" if on_card else "cpu", [0, 1],
                          mesh_dim_names=("dp",))
        out = DTensor.from_local(mine if on_card else mine.cpu(), mesh,
                                 [Shard(0)], run_check=False).full_tensor()
    else:
        dist.barrier()
        out = torch.zeros(0)
    torch.cuda.synchronize()
    print(f"rank {rank} {op} -> {out.cpu().tolist()}", flush=True)
    dist.destroy_process_group()


def main():
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    for op in OPS:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), op, str(r),
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=60)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\nTIMEOUT")
        print(f"=== {op}: exit codes {[p.returncode for p in procs]} "
              f"({time.perf_counter() - t0:.1f} s)")
        for r, out in enumerate(outs):
            for line in out.splitlines()[-20:]:
                print(f"  [{r}] {line}")


if __name__ == "__main__":
    if len(sys.argv) > 1:
        child(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    else:
        main()
