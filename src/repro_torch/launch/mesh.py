"""Device meshes for the port's distributed paths, on ``torch.distributed``.

The reference builds its meshes with ``jax.make_mesh`` from one
controller that sees every device.  PyTorch runs one process per rank
(SPMD): every rank joins one process group, then builds the same
``DeviceMesh`` over it.  :func:`init_group` starts that group without
``torchrun`` (tests, the smoke test, a user's own launcher); under
``torchrun`` pass it the ``RANK`` / ``WORLD_SIZE`` it sets and a
``torch.distributed.TCPStore`` at ``MASTER_ADDR:MASTER_PORT``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..kernels.runtime import resolve_device


def init_group(device=None, *, rank: int, world_size: int, store,
               backend: Optional[str] = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` over
    ``store`` (a ``torch.distributed.Store``) and return the rank's
    device.  The backend is NCCL for a CUDA device and gloo for the CPU;
    ``backend`` overrides it (gloo lets several ranks share one card,
    which NCCL refuses).  On CUDA the rank's card (``device``'s index, else
    ``rank`` modulo the cards present) becomes current before anything
    is built, since the kernel wrappers launch on the current device."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    return device


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the initialized process group, whose
    world size must be ``data * model``.  Its device type is ``"cuda"``
    unless ``device`` asks for the CPU; raises without a process group or,
    for CUDA, without a card."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group (or "
                           "torch.distributed.init_process_group) first")
    device_type = resolve_device(device).type
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks, the process group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=("data", "model"))


PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The production mesh over the initialized process group: ``(16,
    16)`` ``("data", "model")``, or ``(2, 16, 16)`` ``("pod", "data",
    "model")`` with ``multi_pod``.  Raises unless the group has 256 (512)
    ranks.  Its device type is ``"cuda"`` unless ``device`` asks for the
    CPU."""
    shape, names = PRODUCTION[bool(multi_pod)]
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group (or "
                           "init_fake_group for a dry run) first")
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if world != n:
        raise ValueError(f"the {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the process group has {world}")
    device_type = _device_type(device)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _device_type(device) -> str:
    """``device``'s type; on the fake group a CUDA mesh is only named,
    never touched, so it needs no card."""
    if device is not None and dist.get_backend() == "fake":
        return torch.device(device).type
    return resolve_device(device).type


def init_fake_group(world: int, rank: int = 0) -> None:
    """Start the default process group as ``rank`` of ``world`` on the
    ``"fake"`` backend (over ``FakeStore``): one process stands for every
    rank and each collective returns at once.  For the dry run only; a
    fake group already started with this world is kept."""
    # the one private import of the port: the fake backend registers
    # itself when this module is imported
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
