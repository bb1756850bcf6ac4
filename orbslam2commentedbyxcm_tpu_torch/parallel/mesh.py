"""The shard mesh the distributed solvers reduce over: the port's
counterpart of the JAX package's `jax.sharding.Mesh` and its
`dist_ba.make_mesh` (orbslam2commentedbyxcm_tpu/parallel/dist_ba.py:51-60).

A `ShardMesh` holds `n_local` shards in this process, all on one explicit
device, and optionally a torch.distributed process group whose every rank
holds `n_local` shards of its own, so the mesh has `n_local x world_size`
shards; rank r holds shards r * n_local ... (r + 1) * n_local - 1. A shard's
arrays carry a leading shard axis, (n_local, ...), as the JAX package's
`shard_ba_problem` lays them out, and each solver step is written once,
batched over that axis. `psum` replaces `jax.lax.psum` over every mesh axis:
it sums the leading shard axis in one reduction (torch's reductions add in
an order fixed by the shape: a run repeats itself to the bit, where
`index_add_` on the card would add with atomics), then all-reduces the
result over the process group. A mesh without a group is one process, the
counterpart of the JAX tests' 8-virtual-device CPU mesh.

Over `gloo` a CUDA tensor's all-reduce goes through the host (gloo copies
it down and back up), so every cross-process psum costs a device -> host ->
device round trip; `nccl` reduces on the card but wants one GPU per rank.
`n_psum` and `psum_bytes` count the reductions and the bytes each process
contributes to them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _resolve(device) -> torch.device:
    """A device with its index filled in (cuda -> cuda:current)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("ShardMesh(device='cuda'): no CUDA device is available")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def same_device(a, b) -> bool:
    return _resolve(a) == _resolve(b)


class ShardMesh:
    def __init__(self, n_local: int, device="cuda", group=None, axis_names: tuple[str, ...] = ("ici",)):
        if n_local < 1:
            raise ValueError(f"a mesh needs at least one shard per process, got {n_local}")
        self.n_local = int(n_local)
        self.device = _resolve(device)
        self.group = group
        self.world_size = dist.get_world_size(group) if group is not None else 1
        self.rank = dist.get_rank(group) if group is not None else 0
        self.axis_names = tuple(axis_names)
        self.n_psum = 0
        self.psum_bytes = 0

    @property
    def n_shards(self) -> int:
        return self.n_local * self.world_size

    def local(self, a, dtype=None) -> torch.Tensor:
        """This process's shards of a global (n_shards, ...) array, as a
        tensor on the mesh's device."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        if t.shape[0] != self.n_shards:
            raise ValueError(f"leading axis {t.shape[0]} is not the mesh's {self.n_shards} shards")
        lo = self.rank * self.n_local
        return t[lo: lo + self.n_local].to(device=self.device, dtype=dtype)

    def psum(self, *ts: torch.Tensor):
        """Sum each (n_local, ...) tensor over every shard of the mesh ->
        (...). Several tensors go through one all-reduce together."""
        sums = [t.sum(dim=0) for t in ts]
        self.n_psum += 1
        if self.group is not None:
            flat = torch.cat([s.reshape(-1) for s in sums])
            self.psum_bytes += flat.numel() * flat.element_size()
            dist.all_reduce(flat, group=self.group)
            sums = [f.view_as(s) for f, s in zip(torch.split(flat, [s.numel() for s in sums]), sums)]
        else:
            self.psum_bytes += sum(s.numel() * s.element_size() for s in sums)
        return sums[0] if len(sums) == 1 else tuple(sums)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every process's (n_local, ...) shards -> (n_shards, ...) in shard
        order."""
        if self.group is None:
            return t
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return torch.cat(out)


def make_mesh(n_shards: int, device="cuda") -> ShardMesh:
    """A one-process mesh of `n_shards` shards on `device`."""
    return ShardMesh(n_shards, device)
