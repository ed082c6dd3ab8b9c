"""Multi-process rendering over ``torch.distributed`` (counterpart of
``mitransient_tpu/parallel/distributed.py``).

A sharded render splits its samples over the *shards* of a :class:`Mesh`:
devices of this process (CUDA devices, or logical shards on the CPU or on
one card) and, after :func:`init_distributed`, those of every other
process of the world.  Every shard renders its own sample streams into a
film partial; the partials are summed over this process's shards in index
order, then all-reduced across processes (``dist.all_reduce``, the JAX
package's ``psum``).

Backends: NCCL when the shards are CUDA devices, gloo when
``local_device_count`` asks for that many logical CPU shards a process
(the counterpart of the JAX package's ``xla_force_host_platform_device_count``
with gloo collectives).  A gloo all-reduce of CUDA tensors is never taken.

Determinism across layouts: sample streams are keyed by *global* shard
index (``stream = pass * n_shards + rank * local_count + i``), so a render
over N shards draws the same samples whether those shards live in one
process or many; only the order of the final sum differs.

Importing this module initializes nothing.
"""
from __future__ import annotations

import os
import socket
from typing import NamedTuple

import torch
import torch.distributed as dist

# this process's shard devices, set by init_distributed
_LOCAL_DEVICES: list[torch.device] = []


class Mesh(NamedTuple):
    """A 1-D mesh of shards: this process's shard devices (several may be
    one device, whose shards then run in turn), the global index of its
    first shard (``rank * len(devices)``), the global shard count, and the
    process group of the cross-process all-reduce (None: one process, no
    collective)."""

    devices: tuple[torch.device, ...]
    offset: int
    size: int
    group: object | None = None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
) -> None:
    """Join the process group (idempotent).

    ``coordinator_address`` is ``host:port`` of process 0 (a ``tcp://``
    prefix is optional); ``num_processes`` and ``process_id`` are the world
    size and this process's rank.  Without an address the world comes from
    the ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
    environment when it is set (``torchrun``), else it is one process on a
    free localhost port.

    ``local_device_count`` gives this process that many logical CPU shards
    and the gloo backend.  Without it the shards are CUDA devices and the
    backend is NCCL: every CUDA device of a one-process world, or device
    ``LOCAL_RANK`` (default: ``process_id`` modulo the device count) of a
    larger one, since NCCL takes one rank a device."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env.get("WORLD_SIZE", num_processes or 1))
        process_id = int(env.get("RANK", process_id or 0))
    if coordinator_address is None:
        coordinator_address = f"localhost:{_free_port()}"
        num_processes, process_id = 1, 0
    num_processes = 1 if num_processes is None else int(num_processes)
    process_id = 0 if process_id is None else int(process_id)
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = "tcp://" + coordinator_address

    kwargs = {}
    if local_device_count is not None:
        backend = "gloo"
        devices = [torch.device("cpu")] * int(local_device_count)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device for the NCCL backend; "
                "pass local_device_count for logical CPU shards (gloo)")
        n = torch.cuda.device_count()
        if num_processes == 1:
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            local = int(env.get("LOCAL_RANK", process_id)) % n
            devices = [torch.device("cuda", local)]
        backend = "nccl"
        torch.cuda.set_device(devices[0])
        kwargs["device_id"] = devices[0]  # the communicator is made now
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    _LOCAL_DEVICES[:] = devices


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _LOCAL_DEVICES.clear()


def mesh_of(devices) -> Mesh:
    """The mesh of this process's shard ``devices`` and, inside a process
    group whose backend reduces tensors of their kind (NCCL: CUDA, gloo:
    CPU), those of every other process, each with as many shards.  Outside
    a group, or in a one-process group of the other kind, the mesh is this
    process's alone."""
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"shards of one mesh must be of one kind: {devices}")
    n = len(devices)
    if not dist.is_initialized():
        return Mesh(devices, 0, n)
    world, rank = dist.get_world_size(), dist.get_rank()
    want = "nccl" if devices[0].type == "cuda" else "gloo"
    if dist.get_backend() == want:
        return Mesh(devices, rank * n, world * n, dist.group.WORLD)
    if world == 1:
        return Mesh(devices, 0, n)
    raise ValueError(
        f"the process group's backend {dist.get_backend()!r} cannot reduce "
        f"{devices[0].type} shards ({want} can)")


def global_mesh() -> Mesh:
    """The mesh of every shard of every process, in global order (rank
    major): :func:`init_distributed`'s shards; outside a process group,
    this process's CUDA devices."""
    if not dist.is_initialized():
        from .mesh import make_mesh

        return make_mesh()
    return mesh_of(_LOCAL_DEVICES)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested named tuples, tuples, lists and
    dicts; other leaves (host constants, None) are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_add(a, b):
    """Leaf-wise ``a + b`` of two trees of one structure (None stays)."""
    if a is None:
        return None
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(tree_add(x, y) for x, y in zip(a, b)))
    if isinstance(a, (tuple, list)):
        return type(a)(tree_add(x, y) for x, y in zip(a, b))
    return a + b


def replicate(tree, mesh: Mesh) -> list:
    """A copy of ``tree`` (scene tables, camera, NLOS context) on each
    shard's device, one entry a shard; shards of one device share a copy,
    and a tree already on that device is not copied."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = tree_map(lambda x, d=d: x.to(d), tree)
    return [copies[d] for d in mesh.devices]


def reduce_shards(mesh: Mesh, parts):
    """The sum of this process's shard partials ``parts`` (trees of one
    structure, or an iterable yielding them), in index order on the first
    shard's device, all-reduced across the mesh's processes."""
    dev = mesh.devices[0]
    acc = None
    for p in parts:
        p = tree_map(lambda x: x.to(dev), p)
        acc = p if acc is None else tree_add(acc, p)
    if mesh.group is not None:
        for leaf in tree_leaves(acc):
            dist.all_reduce(leaf, op=dist.ReduceOp.SUM, group=mesh.group)
    return acc


def fetch(tree):
    """Host numpy copies of every tensor leaf."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1
