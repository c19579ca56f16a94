"""Shared set-up of the mesh step files (``test_torch_mesh_steps*.py``):
four gloo ranks (``python -c`` subprocesses over one ``TCPStore``, a time
limit each) run the port's step builders over a ``(2, 2)`` ``("data",
"model")`` and a ``(2, 1, 2)`` ``("pod", "data", "model")`` mesh; the test
process runs the same steps with ``mesh=None`` on the same parameters and
inputs, and the files hold the two against each other.

Bounds (float32, the LM train-step files' own): metrics within 1e-5
relative; parameters within 1e-3 of the largest |value| and within
2.1 lr each (a weight whose gradient is zero up to rounding may move lr
either way); the AdamW moments within 1e-3 of the largest (1e-2 for
recurrentgemma, whose RG-LRU cancels about 9 bits); logits of the
prefill and of every decode step within 1e-4 of the largest |value|,
float32 caches.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as tdist

SRC = Path(__file__).resolve().parents[1] / "src"
WORLD = 4
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
B, S, LR, ACCUM = 4, 32, 1e-3, 2
PREFILL, DECODE_STEPS, MAX_LEN = 16, 4, 32
METRIC_TOL, PARAM_TOL, LOGIT_TOL = 1e-5, 1e-3, 1e-4
MOMENT_TOL, RGLRU_TOL, PARAM_LR_MULTIPLE = 1e-3, 1e-2, 2.1

# one rank: every mesh, every arch; whole results of rank 0 to a file,
# every rank's local shard shapes checked against the specs' division
WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[5])
import mesh_parity as mp
from repro_torch.distributed import ctx
from repro_torch.distributed import steps as S
from repro_torch.distributed.pspec import mesh_shape
from repro_torch.models.common import tree_paths
from repro_torch.launch.mesh import init_group

rank, port, out, archs = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4].split(","))
store = dist.TCPStore("127.0.0.1", port, mp.WORLD, is_master=False)
init_group("cpu", rank=rank, world_size=mp.WORLD, store=store)
res = {}
for mname, (shape, names) in mp.MESHES.items():
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    for arch in archs:
        cfg, p, o, tok, tgt, enc, enc_out = mp.inputs(arch)
        ps, os_ = S.train_state_specs(cfg, mesh)
        dp, do = S.shard_state(p, ps, mesh), S.shard_state(o, os_, mesh)
        sizes = mesh_shape(mesh).shape
        bad = torch.tensor(sum(
            tuple(a.to_local().shape) != mp.divided(a.shape, spec, sizes)
            for (_, a), (_, spec) in zip(tree_paths((dp, do)),
                                         tree_paths((ps, os_)))))
        dist.all_reduce(bad)            # every rank's shards
        step = S.make_train_step(cfg, mesh, mp.train_cell(), lr=mp.LR,
                                 grad_accum=mp.ACCUM)
        p2, o2, m2 = step(dp, do, tok, tgt, enc)
        r = mp.results(S.unshard(p2), S.unshard(o2), m2)
        logits = mp.serve(cfg, mesh, dp, tok, enc, enc_out)
        for i, l in enumerate(logits):
            r[f"logits{i}"] = ctx.full(l).numpy()
        r["bad_shards"] = bad.numpy()
        for k, v in r.items():
            res[f"{mname}|{arch}|{k}"] = v
        dist.barrier()
if rank == 0:
    np.savez(out + "/ranks.npz", **res)
dist.destroy_process_group()
"""


def train_cell():
    from repro_torch.configs.shapes import ShapeCell
    return ShapeCell("t", "train", S, B)


def serve_cell():
    from repro_torch.configs.shapes import ShapeCell
    return ShapeCell("p", "prefill", MAX_LEN, B)


def inputs(arch: str):
    """(cfg, params, opt, tokens, targets, enc_frames, enc_out) of the
    arch's smoke config, from seeds: the same on every rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import init_params
    from repro_torch.optim import adamw_init
    cfg = get_smoke_config(arch)
    p = init_params(tf.pdefs(cfg), torch.Generator().manual_seed(0),
                    torch.float32, "cpu")
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), np.int32))
    tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S), np.int32))
    enc = enc_out = None
    if cfg.is_encoder_decoder:
        enc = torch.from_numpy((rng.normal(size=(
            B, cfg.encoder_len, cfg.d_model)) * 0.02).astype(np.float32))
        with torch.no_grad():
            enc_out = tf.encode(p, cfg, enc)
    return cfg, p, adamw_init(p), tok, tgt, enc, enc_out


def bits(a: np.ndarray) -> np.ndarray:
    """``a``'s bytes (0-d arrays too)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def divided(shape, spec, sizes):
    """``shape`` with each dimension divided by the extent of the axes its
    part of ``spec`` names."""
    out = []
    for n, part in zip(shape, spec):
        names = (part,) if isinstance(part, str) else (part or ())
        ext = 1
        for a in names:
            ext *= sizes[a]
        out.append(n // ext)
    return tuple(out)


def results(params, opt, metrics):
    from repro_torch.models.common import tree_paths
    r = {f"m_{k}": np.asarray(float(v)) for k, v in metrics.items()}
    for name, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
        for path, a in tree_paths(tree):
            r[f"{name}_{'/'.join(map(str, path))}"] = a.detach().numpy()
    return r


def serve(cfg, mesh, params, tok, enc, enc_out):
    """Prefill of PREFILL tokens, then DECODE_STEPS decode steps (float32
    caches): the logits of each."""
    from repro_torch.distributed import steps as S
    pre = S.make_prefill(cfg, mesh, serve_cell(), cache_dtype=torch.float32)
    dec = S.make_decode_step(cfg, mesh, serve_cell())
    logits, caches = pre(params, tok[:, :PREFILL], enc)
    out = [logits]
    for i in range(DECODE_STEPS):
        pos = PREFILL + i
        l, caches = dec(params, caches, tok[:, pos:pos + 1], pos, enc_out)
        out.append(l)
    return out


def one_device(arch: str):
    """The same train step and serving run with ``mesh=None``."""
    from repro_torch.distributed import steps as S
    cfg, p, o, tok, tgt, enc, enc_out = inputs(arch)
    step = S.make_train_step(cfg, None, train_cell(), lr=LR,
                             grad_accum=ACCUM)
    p2, o2, m2 = step(p, o, tok, tgt, enc)
    r = results(p2, o2, m2)
    for i, l in enumerate(serve(cfg, None, p, tok, enc, enc_out)):
        r[f"logits{i}"] = l.numpy()
    r["before"] = {k[2:]: v.copy() for k, v in
                   results(p, o, m2).items() if k.startswith("p_")}
    return r


def run_ranks(archs, out: Path, limit_s: int, local):
    """Start the four ranks on ``archs``, call ``local()`` meanwhile, wait
    (at most ``limit_s`` seconds) and return (rank 0's results by
    ``(mesh, arch)``, ``local()``'s value)."""
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    here = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(store.port), str(out),
         ",".join(archs), here], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        mine = local()
        logs = [p.communicate(timeout=limit_s)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    raw = np.load(out / "ranks.npz")
    res = {}
    for key in raw.files:
        mname, arch, k = key.split("|")
        res.setdefault((mname, arch), {})[k] = raw[key]
    return res, mine


def check_train(arch: str, got: dict, want: dict) -> None:
    for k in ("loss", "ce", "aux", "gnorm"):
        g, w = float(got[f"m_{k}"]), float(want[f"m_{k}"])
        assert abs(g - w) <= METRIC_TOL * abs(w) + 1e-12, (k, g, w)
    tol = RGLRU_TOL if arch == "recurrentgemma-2b" else MOMENT_TOL
    for name, bound in (("p", PARAM_TOL), ("mu", tol), ("nu", tol)):
        keys = [k for k in want if k.startswith(name + "_")]
        assert keys and set(keys) == {k for k in got
                                      if k.startswith(name + "_")}
        scale = max(np.abs(want[k]).max() for k in keys)
        for k in keys:
            err = np.abs(got[k].astype(np.float64) - want[k]).max()
            assert err <= bound * scale, (k, err, scale)
            if name == "p":
                assert err <= PARAM_LR_MULTIPLE * LR, (k, err / LR)
    moved = {k[2:] for k in want if k.startswith("p_")
             and not np.array_equal(want[k], want["before"][k[2:]])}
    assert moved == {k[2:] for k in got if k.startswith("p_")
                     and not np.array_equal(got[k], want["before"][k[2:]])}


def check_serve(got: dict, want: dict) -> None:
    for i in range(DECODE_STEPS + 1):
        g, w = got[f"logits{i}"], want[f"logits{i}"]
        assert g.shape == w.shape, (i, g.shape, w.shape)
        err = np.abs(g.astype(np.float64) - w).max()
        assert err <= LOGIT_TOL * np.abs(w).max(), (i, err)


# the Trainer over (2, 2): two steps and a checkpoint, then a Trainer over
# (4, 1) restores it; rank 0 saves both states whole
TRAINER_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
import mesh_parity as mp
from repro_torch.distributed import steps as S
from repro_torch.launch.mesh import init_group, make_host_mesh

rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
store = dist.TCPStore("127.0.0.1", port, mp.WORLD, is_master=False)
init_group("cpu", rank=rank, world_size=mp.WORLD, store=store)
tr = mp.trainer(make_host_mesh(2, 2, device="cpu"), out + "/ckpt")
assert not tr.init_or_restore()
hist = tr.run()
saved = mp.flat(S.unshard((tr.params, tr.opt)))
back = mp.trainer(make_host_mesh(4, 1, device="cpu"), out + "/ckpt")
assert back.init_or_restore() and back.step == mp.TRAINER_STEPS
restored = mp.flat(S.unshard((back.params, back.opt)))
if rank == 0:
    np.savez(out + "/trainer.npz",
             **{"saved|" + k: v for k, v in saved.items()},
             **{"restored|" + k: v for k, v in restored.items()},
             losses=np.array([h["loss"] for h in hist]))
dist.destroy_process_group()
"""
TRAINER_STEPS = 2


def tiny_cfg():
    """The reference trainer tests' tiny config: qwen3's smoke family at 2
    layers, d_model 64, vocab 256."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("qwen3-14b"), n_layers=2,
                               d_model=64, n_heads=4, n_kv_heads=2,
                               head_dim=16, d_ff=128, vocab=256, remat=False)


def trainer(mesh, ckpt_dir):
    from repro_torch.train import Trainer, TrainConfig
    return Trainer(tiny_cfg(), mesh, train_cell(),
                   TrainConfig(steps=TRAINER_STEPS, ckpt_every=TRAINER_STEPS,
                               ckpt_dir=ckpt_dir, lr=LR, grad_accum=ACCUM,
                               log_every=1), device="cpu")


def flat(tree) -> dict:
    """{path: numpy array} of a tree of tensors."""
    from repro_torch.models.common import tree_paths
    return {"/".join(map(str, p)): a.detach().numpy()
            for p, a in tree_paths(tree)}


def run_trainer_ranks(out: Path, limit_s: int):
    """The Trainer ranks' (saved, restored, losses)."""
    store = tdist.TCPStore("127.0.0.1", 0, None, True,
                           wait_for_workers=False)
    here = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}"
               f"{os.environ.get('PYTHONPATH', '')}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", TRAINER_WORKER, str(r), str(store.port),
         str(out), here], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=limit_s)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    raw = np.load(out / "trainer.npz")
    part = {w: {k.split("|", 1)[1]: raw[k] for k in raw.files
                if k.startswith(w + "|")} for w in ("saved", "restored")}
    return part["saved"], part["restored"], raw["losses"]
