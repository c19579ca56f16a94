"""Roofline terms of a dry-run step, per device, at the H100's datasheet
constants.

The constants are those of one NVIDIA H100 80GB HBM3 SXM at 700 W (its
datasheet): 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
HBM3, and 450 GB/s per direction of NVLink 4 (900 GB/s both ways).
Terms are computed from *per-device* quantities:

    compute_s    = flops_per_device    / PEAK_FLOPS
    memory_s     = bytes_per_device    / HBM_BW
    collective_s = coll_bytes_per_dev  / LINK_BW

The quantities come from :class:`CostCounter`, a dispatch mode over one
run of the step on fake tensors (``launch/dryrun.py``): it sees every
operator on each rank's *local* shards, below DTensor, so

* flops are ``torch.utils.flop_counter``'s formulas on the local shapes
  (counted at the DTensor level they would be the global product);
* bytes accessed are each operator's local operand and result bytes
  (views move nothing and are not counted; no fusion is assumed, so this
  is an upper bound on what fused kernels would move);
* collective bytes are the operand bytes of each ``_c10d_functional``
  collective, by kind.

The dry run counts two unrolled probes (1 and 2 pattern periods of
layers) and extrapolates:

    total(L) = probe1 + (L - period) / period * (probe2 - probe1)

which is exact for homogeneous periods (all ten archs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12      # bf16 dense tensor-core flop/s, H100 SXM datasheet
HBM_BW = 3.35e12         # bytes/s of HBM3, H100 SXM datasheet
LINK_BW = 450e9          # bytes/s per direction of NVLink 4, H100 SXM

# _c10d_functional operator -> the collective's kind (the reference's HLO
# names)
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


@dataclasses.dataclass
class CostPoint:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_by_op: Dict[str, int]


def tensors_in(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)

    walk(tree)
    return out


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode that sees the operators run on local (per-rank)
    tensors: an operator called on DTensors is left to DTensor, whose
    local operators then come back here, and the operators DTensor runs on
    global shapes to propagate its metadata are not shown (``paused``).
    Subclasses implement ``seen(func, args, kwargs, out)``."""

    def __init__(self):
        super().__init__()
        self.paused = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, name):
            raise RuntimeError(f"this torch's DTensor has no "
                               f"ShardingPropagator.{name}: its metadata "
                               f"propagation cannot be told from local work")
        self._orig = getattr(ShardingPropagator, name)
        mode, orig = self, self._orig

        def paused(prop, *a, **k):
            mode.paused += 1
            try:
                return orig(prop, *a, **k)
            finally:
                mode.paused -= 1

        setattr(ShardingPropagator, name, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        setattr(ShardingPropagator, "_propagate_tensor_meta_non_cached",
                self._orig)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.paused:
            self.seen(func, args, kwargs, out)
        return out

    def seen(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CostCounter(LocalOpMode):
    """Counts flops, bytes accessed and collective bytes of the operators
    run on local tensors while it is active."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.coll_by_op: Dict[str, int] = {}

    def seen(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                n = sum(nbytes(t) for t in tensors_in((args, kwargs)))
                self.coll_by_op[kind] = self.coll_by_op.get(kind, 0) + n
            return
        if packet in self._flops:
            self.flops += float(self._flops[packet](
                *args, **kwargs, out_val=out))
        if not func.is_view and ns == "aten":
            self.bytes_accessed += sum(
                nbytes(t) for t in tensors_in((args, kwargs, out)))

    def point(self) -> CostPoint:
        return CostPoint(flops=self.flops, bytes_accessed=self.bytes_accessed,
                         coll_bytes=float(sum(self.coll_by_op.values())),
                         coll_by_op=dict(self.coll_by_op))


def extrapolate(probe1: CostPoint, probe2: CostPoint, n_layers: int,
                period: int) -> CostPoint:
    k = (n_layers - period) / period

    def ex(a, b):
        return a + k * (b - a)

    ops = set(probe1.coll_by_op) | set(probe2.coll_by_op)
    coll = {o: int(ex(probe1.coll_by_op.get(o, 0),
                      probe2.coll_by_op.get(o, 0))) for o in ops}
    return CostPoint(flops=ex(probe1.flops, probe2.flops),
                     bytes_accessed=ex(probe1.bytes_accessed,
                                       probe2.bytes_accessed),
                     coll_bytes=ex(probe1.coll_bytes, probe2.coll_bytes),
                     coll_by_op=coll)


def roofline_terms(cost: CostPoint) -> Dict[str, float]:
    compute_s = cost.flops / PEAK_FLOPS
    memory_s = cost.bytes_accessed / HBM_BW
    collective_s = cost.coll_bytes / LINK_BW
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    total = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": total,
        "roofline_fraction": compute_s / total if total > 0 else 0.0,
    }


def model_flops(cfg, cell, chips: int) -> float:
    """Analytic MODEL_FLOPS per device: 6·N_active·tokens (train) or
    2·N_active·tokens (inference) — the 'useful compute' yardstick."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens / chips
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens / chips
    tokens = cell.global_batch  # one step
    return 2.0 * n_active * tokens / chips
