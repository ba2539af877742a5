"""Process groups for data-parallel training (counterpart of
deblur_e_nerf_tpu/parallel/mesh.py).

The JAX package compiles one SPMD program over a device mesh. The port
runs one process per rank, as the reference does with PyTorch DDP
(reference scripts/run.py:84-89): `init` joins a torch.distributed group
and binds the rank's device, `cuda:local_rank` (or the CPU).

- The backend is `nccl` on CUDA and `gloo` on the CPU. NCCL takes one card
  per rank, so a CUDA mesh with more ranks on a node than visible cards
  raises. `gloo` over CUDA tensors runs only when asked for by name
  (`backend="gloo"`); its ranks may then share a card (rank i on
  `cuda:i % device_count`), which rehearses a mesh on one card.
- `num_nodes` is the JAX package's 2-D ('replica', 'data') mesh
  (`make_multislice_mesh`): the batch shards over both axes in row-major
  order, so the math is that of a 1-D mesh of `mesh_devices` ranks; rank r
  is local rank r % (mesh_devices / num_nodes) of node
  r // (mesh_devices / num_nodes).
- `spawn` starts the ranks of one host itself (start method `spawn`);
  `from_env` joins a group that `torchrun` started (WORLD_SIZE set).
"""

import datetime
import os
import socket
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the collectives' timeout: rank 0 evaluates and saves while the others
# wait at a barrier
DEFAULT_TIMEOUT_S = 1800


@dataclass(frozen=True)
class Mesh:
    world: int
    rank: int
    local_rank: int
    num_nodes: int
    backend: str
    device: torch.device


_current = None


def current():
    """This process's Mesh, or None outside a group of `init`."""
    return _current


def check(mesh_devices, num_nodes=1, device="cuda", backend=None):
    """Validate a mesh of `mesh_devices` ranks over `num_nodes` nodes on
    `device` ('cuda' or 'cpu'); returns the backend (default nccl on CUDA,
    gloo on the CPU)."""
    world, nodes = int(mesh_devices), int(num_nodes or 1)
    if world < 1 or nodes < 1 or world % nodes:
        raise ValueError(f"num_nodes {nodes} does not divide mesh_devices "
                         f"{world}")
    device_type = torch.device(device).type
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if device_type == "cpu" and backend != "gloo":
        raise ValueError(f"backend {backend!r} does not run on the CPU; "
                         "use gloo")
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise ValueError(f"mesh_devices {world}: no CUDA device is "
                             "visible; pass device='cpu' to rehearse the "
                             "mesh with gloo")
        if backend == "nccl" and world // nodes > count:
            raise ValueError(
                f"mesh_devices {world} over {nodes} node(s) puts "
                f"{world // nodes} ranks on a node with {count} visible "
                "CUDA device(s): NCCL takes one card per rank (ask for "
                "backend 'gloo' by name to share a card)")
    return backend


def init(mesh_devices, rank, num_nodes=1, device="cuda", backend=None,
         init_method="env://", timeout_s=DEFAULT_TIMEOUT_S, local_rank=None):
    """Join the group as `rank` of `mesh_devices`; returns its Mesh."""
    global _current
    backend = check(mesh_devices, num_nodes, device, backend)
    world, nodes = int(mesh_devices), int(num_nodes or 1)
    if local_rank is None:
        local_rank = int(rank) % (world // nodes)
    dev = torch.device("cpu")
    if torch.device(device).type == "cuda":
        dev = torch.device("cuda",
                           int(local_rank) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s))
    _current = Mesh(world=world, rank=int(rank), local_rank=int(local_rank),
                    num_nodes=nodes, backend=backend, device=dev)
    return _current


def from_env(mesh_devices=None, num_nodes=1, device="cuda", backend=None,
             timeout_s=DEFAULT_TIMEOUT_S):
    """Join the group `torchrun` started (WORLD_SIZE, RANK, LOCAL_RANK,
    LOCAL_WORLD_SIZE): LOCAL_WORLD_SIZE x num_nodes must equal WORLD_SIZE,
    and `mesh_devices`, when given, WORLD_SIZE."""
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nodes = int(num_nodes or 1)
    if mesh_devices is not None and int(mesh_devices) != world:
        raise ValueError(f"mesh_devices {mesh_devices} != WORLD_SIZE "
                         f"{world}")
    if local_world * nodes != world:
        raise ValueError(f"LOCAL_WORLD_SIZE {local_world} x num_nodes "
                         f"{nodes} != WORLD_SIZE {world}")
    return init(world, int(os.environ["RANK"]), nodes, device, backend,
                "env://", timeout_s, int(os.environ["LOCAL_RANK"]))


def destroy():
    global _current
    if dist.is_initialized():
        dist.destroy_process_group()
    _current = None


def free_tcp_address():
    """A rendezvous address on a free localhost port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _run_rank(rank, target, mesh_kwargs, args, threads):
    if threads:
        torch.set_num_threads(threads)
    mesh = init(rank=rank, **mesh_kwargs)
    try:
        target(mesh, *args)
    finally:
        destroy()


def spawn(target, mesh_devices, args=(), num_nodes=1, device="cuda",
          backend=None, init_method=None, timeout_s=DEFAULT_TIMEOUT_S,
          join_timeout_s=None, threads=None):
    """Run `target(mesh, *args)` in `mesh_devices` processes of this host
    (start method spawn; `target` must be importable by name), one per
    rank, and join them. A rank that raises or dies fails the call and
    ends the others; with `join_timeout_s`, so do ranks still running
    after it. `threads`: torch intra-op threads per rank."""
    backend = check(mesh_devices, num_nodes, device, backend)
    mesh_kwargs = dict(mesh_devices=int(mesh_devices), num_nodes=num_nodes,
                       device=str(torch.device(device).type),
                       backend=backend,
                       init_method=init_method or free_tcp_address(),
                       timeout_s=timeout_s)
    ctx = mp.start_processes(_run_rank, args=(target, mesh_kwargs,
                                              tuple(args), threads),
                             nprocs=int(mesh_devices), join=False,
                             start_method="spawn")
    deadline = (None if join_timeout_s is None
                else time.monotonic() + join_timeout_s)
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{mesh_devices} ranks still running "
                                   f"after {join_timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
        for proc in ctx.processes:
            proc.join(10)
