"""End-to-end example: train a ~100M-parameter qwen3-family model on the
synthetic token pipeline with checkpoints and an (optional) simulated
mid-run crash + resume, on the GPU unless told otherwise.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--crash-at 60]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \
        --steps 4 --crash-at 2 --batch 2 --seq 32 --log-every 1
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.train import Trainer, TrainConfig


def build_cfg():
    # ~100M params: 12L, d=512, ff=2048, vocab 32k
    base = get_smoke_config("qwen3-14b")
    return dataclasses.replace(
        base, n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab=32_000, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="simulate a failure at this step, then resume")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = build_cfg()
    n = cfg.param_count()
    print(f"model: {cfg.name}-derived, {n/1e6:.0f}M params")
    cell = ShapeCell("example", "train", args.seq, args.batch)
    shutil.rmtree(args.ckpt_dir, ignore_errors=True)

    tcfg = TrainConfig(steps=args.steps, ckpt_every=50,
                       ckpt_dir=args.ckpt_dir, lr=3e-4,
                       log_every=args.log_every)
    trainer = Trainer(cfg, None, cell, tcfg, device=args.device)
    trainer.init_or_restore()

    resumed_at = None
    if args.crash_at:
        # run until the crash point, drop everything, then resume
        trainer.tcfg = dataclasses.replace(tcfg, steps=args.crash_at)
        trainer.run(on_step=lambda s, m: print("  ", m))
        print(f"-- simulated crash at step {trainer.step}; restarting --")
        trainer = Trainer(cfg, None, cell, tcfg, device=args.device)
        resumed = trainer.init_or_restore()
        resumed_at = trainer.step
        print(f"resumed={resumed} at step {trainer.step}")

    hist = trainer.run(on_step=lambda s, m: print("  ", m))
    first, last = hist[0]["ce"], hist[-1]["ce"]
    print(f"CE {first:.3f} -> {last:.3f} over {trainer.step} steps")
    assert last < first, "loss should decrease"
    return {"hist": hist, "resumed_at": resumed_at, "steps": trainer.step}


if __name__ == "__main__":
    main()
