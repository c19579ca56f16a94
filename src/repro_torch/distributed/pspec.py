"""A jax-free ``PartitionSpec`` and a view of a mesh's axes.

``P`` holds one entry per tensor dimension: ``None`` (replicated), a
mesh axis name, or a tuple of names.  Entries are canonical as the
reference's ``PartitionSpec`` makes them (an empty tuple is ``None``, a
tuple of one name is the name), and ``P`` is a tuple, so a spec tree of
the port equals the reference's axis for axis by ``tuple(spec)``.  The
tree walkers of ``models.common`` treat it as a leaf.

A mesh is anything with ``.shape`` (a dict of axis sizes) and
``.axis_names``, such as a stand-in with no devices, or a torch
``DeviceMesh`` (its ``mesh_dim_names`` and ``size(i)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


def _canonical(part):
    if isinstance(part, (tuple, list)):
        if not part:
            return None
        return part[0] if len(part) == 1 else tuple(part)
    return part


class P(tuple):
    """``P(*parts)``: the spec of a tensor, one part per dimension."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_canonical(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]


def mesh_shape(mesh) -> MeshShape:
    """The axis names and sizes of ``mesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshShape({n: mesh.size(i) for i, n in enumerate(names)},
                         tuple(names))
    return MeshShape(dict(mesh.shape), tuple(mesh.axis_names))


def mesh_devices(mesh) -> int:
    """The number of devices of ``mesh`` (1 for ``None``)."""
    return 1 if mesh is None else math.prod(mesh_shape(mesh).shape.values())


def placements(spec, mesh):
    """``spec`` as DTensor placements over ``mesh``'s dims: ``Shard(d)``
    on each mesh dim that dimension ``d`` names, ``Replicate()`` on the
    others and on axes of extent 1 (a shard of one is the whole tensor).

    Where one dimension names several axes (``("pod", "data")``), the
    reference shards it major to minor in the order named; DTensor orders
    the shards of one dimension by mesh-dim order.  Each shard's size and
    the global tensor are the same either way; which device holds which
    slice differs when the named order is not the mesh's (``kv_seq_axes``'
    ``["model", "pod", "data"]``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_shape(mesh).axis_names
    dim_of = {}
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            if a in dim_of:
                raise ValueError(f"mesh axis {a!r} named twice in {spec}")
            dim_of[a] = d
    unknown = set(dim_of) - set(names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} that the "
                         f"mesh {names} lacks")
    sizes = mesh_shape(mesh).shape
    return tuple(Shard(dim_of[a]) if a in dim_of and sizes[a] > 1
                 else Replicate() for a in names)

