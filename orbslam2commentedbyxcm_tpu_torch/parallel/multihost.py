"""Process groups and the processes x local-shards mesh: the port's
counterpart of orbslam2commentedbyxcm_tpu/parallel/multihost.py.

  * `initialize()` brings up torch.distributed from explicit arguments or
    from torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK) and returns False when neither is given: one process, as the JAX
    package's `initialize()` without its JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID variables. The port reads torchrun's
    variables, not the JAX ones.
  * The backend is an argument: `gloo` runs on the CPU and lets several
    ranks share one card (each stages its CUDA tensors through the host);
    `nccl` is for one GPU per rank (NCCL refuses two ranks on one device).
  * `make_hybrid_mesh(n_local)` lays the world out as processes x local
    shards, axes ("dcn", "ici"), or ("ici",) in one process: the layout the
    JAX package's hybrid DCN x ICI device mesh stood for. Its explicit
    `make_mesh_2d` has no counterpart here.

The distributed solvers (parallel/dist_ba, parallel/dist_posegraph) psum over
the whole mesh: each process sums its local shards first, then one
all-reduce crosses the processes.

`launch_local(fn, world_size)` runs fn in `world_size` spawned processes of
this machine with torchrun's RANK / WORLD_SIZE (and any other variables
given) set, and returns what each rank returned: the way a test or a smoke
run brings a group up without torchrun.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback

import torch.distributed as dist
import torch.multiprocessing as mp

from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import ShardMesh


JOIN_TIMEOUT_S = 120.0  # a rank that waits longer for the others (to join, or in a collective) raises


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str = "gloo",
) -> bool:
    """Join the process group. Returns True if distributed mode is active
    (now or already), False for one process. `init_method` is a
    torch.distributed URL (tcp://host:port, file://path); without it the
    group is read from torchrun's environment."""
    if dist.is_initialized():
        return True
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or world_size is None:
            return False  # one process
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    return True


def make_hybrid_mesh(n_local: int = 1, device="cuda") -> ShardMesh:
    """Processes x `n_local` shards on `device` over the world group; a flat
    ("ici",) mesh when this is the only process."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return ShardMesh(n_local, device, axis_names=("ici",))
    return ShardMesh(n_local, device, group=dist.group.WORLD, axis_names=("dcn", "ici"))


def _rank_entry(rank: int, world_size: int, env: dict, fn, args, out) -> None:
    os.environ.update(env, RANK=str(rank), WORLD_SIZE=str(world_size))
    try:
        out.put((rank, fn(*args), None))
    except BaseException:
        out.put((rank, None, traceback.format_exc()))  # the launcher raises it
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_local(fn, world_size: int, args=(), env: dict | None = None, timeout_s: float = 120.0) -> list:
    """Run fn(*args) in `world_size` spawned processes (spawn, never fork: the
    caller may hold a CUDA context) with RANK / WORLD_SIZE and `env` set;
    fn is expected to call `initialize()`. Returns the ranks' results in
    rank order. Raises if a rank raised or the ranks are not done within
    `timeout_s`; every process is stopped either way."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(r, world_size, dict(env or {}), fn, args, out), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(results) < world_size:
            try:
                rank, res, err = out.get(timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"launch_local: {world_size - len(results)} rank(s) not done in {timeout_s} s")
            if err is not None:  # the other ranks may wait in a collective for it: stop them
                raise RuntimeError(f"launch_local: rank {rank} raised:\n{err}")
            results[rank] = res
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [results[r] for r in range(world_size)]
