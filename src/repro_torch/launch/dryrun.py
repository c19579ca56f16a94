"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once on
meta tensors over the production mesh of a fake process group.

Per cell:
  1. build the production config (padded heads/vocab) and the mesh
     (16×16 single-pod or 2×16×16 multi-pod) over a ``"fake"`` process
     group of 256 or 512 ranks (``launch.mesh.init_fake_group``): this
     process stands for rank 0 and every collective returns at once,
  2. place the cell's state (parameters and AdamW moments, or parameters
     and decode caches) as DTensors by the reference's specs, each rank's
     shard a ``meta`` tensor (shapes and dtypes, no memory on any device;
     every tensor the step makes is one too),
  3. run the cell's step (train step / prefill / decode step) once,
     recording the local shards' live bytes (``mem``),
  4. run two unrolled probes (1 and 2 pattern periods of layers) under
     ``launch.roofline.CostCounter`` and extrapolate flops, bytes and
     collective bytes to full depth (``cost``, ``roofline``).

The record has the reference's keys.  ``compile_s`` is the seconds the
one run of the full step took (the counterpart of lowering and
compiling).  ``mem``'s method: ``argument_bytes`` and ``output_bytes``
are the local shard bytes of the step's inputs and outputs;
``temp_bytes`` is the largest sum of the local tensors the step made and
still held at one time (each operator's new results, freed when Python
frees them); ``peak_bytes`` is ``argument_bytes + temp_bytes``.
``cost_full_scanbody_once`` is the count of that full run: the port runs
no scan, so every layer and microbatch is in it (the reference's counts
a scan body once); ``cost`` is the probes' extrapolation.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k --device cpu
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-probes] --device cpu
  python -m repro_torch.launch.dryrun --arch qwen3-14b --all-shapes --both-meshes --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

from repro_torch.launch.roofline import LocalOpMode, nbytes, tensors_in

MEM_METHOD = ("argument/output: local shard bytes of the step's inputs and "
              "outputs; temp: peak live bytes of the local tensors the step "
              "made (meta tensors, freed as Python frees them); peak = "
              "argument + temp")


# collective wrappers that return their input: no new memory
ALIASES = ("wait_tensor", "_wrap_tensor_autograd")


class LiveBytes(LocalOpMode):
    """Tracks the bytes of the local tensors made while it is active: each
    new (not a view, not written in place) result of an operator counts
    until Python frees it; ``peak`` is the most live at once."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def seen(self, func, args, kwargs, out) -> None:
        if func.is_view or func._schema.is_mutable or \
                func._overloadpacket.__name__ in ALIASES:
            return
        ins = {id(t) for t in tensors_in((args, kwargs))}
        for t in tensors_in(out):
            if id(t) in ins:
                continue
            n = nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)


class Both(LocalOpMode):
    """``LiveBytes`` and a ``CostCounter`` in one dispatch mode."""

    def __init__(self, live: LiveBytes, cost):
        super().__init__()
        self.parts = (live, cost)

    def seen(self, func, args, kwargs, out) -> None:
        for p in self.parts:
            p.seen(func, args, kwargs, out)


def _fake_world(world: int) -> None:
    """The default process group as a fake group of ``world`` ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_fake_group
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    init_fake_group(world)


def _state_bytes(tree) -> int:
    """Local bytes of the DTensor leaves of ``tree``."""
    from repro_torch.models.common import tree_leaves
    return sum(nbytes(a.to_local()) for a in tree_leaves(tree)
               if hasattr(a, "to_local"))


def _input_bytes(inputs, mesh) -> int:
    """Local bytes of the plain inputs (whole on every rank, placed by the
    step): ``(tensor, spec)`` pairs."""
    from repro_torch.distributed.ctx import shard_extent
    from repro_torch.distributed.pspec import placements
    total = 0
    for t, spec in inputs:
        local, _ = shard_extent(t.shape, mesh, placements(spec, mesh))
        n = 1
        for d in local:
            n *= d
        total += n * t.element_size()
    return total


def _build_step(cfg, mesh, cell, probe: bool = False, variant=None):
    """(step, args, inputs) of ``cell``'s kind on ``mesh``: the state
    placed by the reference's specs, every tensor on ``meta``; ``inputs``
    the plain arguments with the specs the step places them by."""
    from repro_torch.configs.shapes import input_specs
    from repro_torch.distributed.pspec import P
    from repro_torch.distributed.steps import (_data_pspec, batch_axes_for,
                                               make_decode_step,
                                               make_abstract_inputs,
                                               make_prefill, make_train_step)
    v = variant or {}
    fsdp = v.get("fsdp", True)
    specs = input_specs(cfg, cell)
    tok = _data_pspec(mesh, cell.global_batch)
    enc = P(batch_axes_for(mesh, cell.global_batch) or None, None, None)
    state = make_abstract_inputs(cfg, mesh, cell, local=True, fsdp=fsdp)
    if cell.kind == "train":
        # probes run without microbatches so the count sees the whole
        # step's layer work once
        step = make_train_step(
            cfg, mesh, cell, grad_accum=1 if probe else v.get("grad_accum", 8),
            fsdp=fsdp, moe_weight_gather=v.get("moe_weight_gather", False))
        inputs = [(specs["tokens"], tok), (specs["targets"], tok)]
        if cfg.is_encoder_decoder:
            inputs.append((specs["enc_frames"], enc))
        return step, state + tuple(t for t, _ in inputs), inputs
    if cell.kind == "prefill":
        step = make_prefill(cfg, mesh, cell)
        inputs = [(specs["tokens"], tok)]
        if cfg.is_encoder_decoder:
            inputs.append((specs["enc_frames"], enc))
        return step, state + tuple(t for t, _ in inputs), inputs
    step = make_decode_step(cfg, mesh, cell,
                            feature_shard=v.get("feature_shard", None),
                            fsdp=fsdp)
    # the last position of the cache: a step at the cell's full context
    args = state + (specs["tokens"], cell.seq_len - 1)
    inputs = [(specs["tokens"], tok)]
    if cfg.is_encoder_decoder:
        args = args + (specs["enc_out"],)
        inputs.append((specs["enc_out"], enc))
    return step, args, inputs


def dry_run(cfg, mesh, cell, *, probes: bool = True, variant=None,
            verbose: bool = True) -> dict:
    """``cell``'s step of ``cfg`` on ``mesh`` (a mesh over a fake group)
    run once on meta tensors: the record's ``status``, ``compile_s``,
    ``mem``, ``cost_full_scanbody_once`` and, with ``probes``, ``cost``
    and ``roofline`` (``mesh``'s size is the chip count of
    ``model_flops``)."""
    from repro_torch.launch import roofline as rl

    def run(c, tag, mode):
        step, args, inputs = _build_step(c, mesh, cell,
                                         probe=tag.startswith("probe"),
                                         variant=variant)
        t0 = time.time()
        with mode:
            out = step(*args)
        secs = time.time() - t0
        if verbose:
            print(f"  [{tag}] {secs:.1f}s", flush=True)
        return args, inputs, out, secs

    tracker, full = LiveBytes(), rl.CostCounter()
    args, inputs, out, secs = run(cfg, "full", Both(tracker, full))
    arg_b = _state_bytes(args) + _input_bytes(inputs, mesh)
    out_b = _state_bytes(out)
    del args, inputs, out
    rec = {"status": "ok", "compile_s": round(secs, 1), "mem": {
        "method": MEM_METHOD,
        "argument_bytes": int(arg_b),
        "output_bytes": int(out_b),
        "temp_bytes": int(tracker.peak),
        "peak_bytes": int(arg_b + tracker.peak),
    }, "cost_full_scanbody_once": dataclasses.asdict(full.point())}
    if probes:
        period = len(cfg.pattern)
        points = []
        for k in (1, 2):
            probe = dataclasses.replace(cfg, n_layers=k * period,
                                        force_unroll=True)
            counter = rl.CostCounter()
            run(probe, f"probe{k}", counter)
            points.append(counter.point())
        cost = rl.extrapolate(points[0], points[1], cfg.n_layers, period)
        rec["cost"] = dataclasses.asdict(cost)
        terms = rl.roofline_terms(cost)
        mf = rl.model_flops(cfg, cell, mesh.size())
        terms["model_flops_per_dev"] = mf
        terms["useful_fraction"] = mf / cost.flops if cost.flops else 0.0
        rec["roofline"] = terms
    return rec


def run_cell(arch: str, shape: str, multi_pod: bool, probes: bool = True,
             verbose: bool = True, variant=None, device=None):
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, cell_applicable
    from repro_torch.launch.mesh import make_production_mesh

    cell = SHAPES[shape]
    cfg = get_config(arch, production=True)
    ok, why = cell_applicable(cfg, cell)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "applicable": ok, "note": why}
    if not ok:
        rec["status"] = "skipped"
        return rec
    try:
        _fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        rec.update(dry_run(cfg, mesh, cell, probes=probes, variant=variant,
                           verbose=verbose))
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-shapes", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-probes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (cuda unless 'cpu'); "
                         "nothing is allocated on it")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs
    from repro_torch.configs.shapes import SHAPES

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.all_shapes or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    records = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}"
                fp = outdir / f"{tag}.json"
                if fp.exists():
                    print(f"skip (exists): {tag}", flush=True)
                    records.append(json.loads(fp.read_text()))
                    continue
                print(f"=== {tag}", flush=True)
                t0 = time.time()
                rec = run_cell(arch, shape, mp, probes=not args.skip_probes,
                               device=args.device)
                rec["wall_s"] = round(time.time() - t0, 1)
                fp.write_text(json.dumps(rec, indent=1))
                print(f"  -> {rec['status']} ({rec['wall_s']}s)", flush=True)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
