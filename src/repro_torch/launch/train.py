"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
        --steps 100 --smoke            # reduced config, on the GPU
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 4 \
        --device cpu

One device: the Trainer and its step run on ``--device`` (the GPU unless
given).
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.train import Trainer, TrainConfig

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cell = ShapeCell("cli", "train", args.seq, args.batch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=max(args.steps // 2, 1),
                       ckpt_dir=args.ckpt_dir, lr=args.lr,
                       grad_accum=args.grad_accum, log_every=10)
    tr = Trainer(cfg, None, cell, tcfg, device=args.device)
    resumed = tr.init_or_restore()
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"resumed={resumed} start_step={tr.step} device={tr.device}")
    return tr.run(on_step=lambda s, m: print(m))


if __name__ == "__main__":
    main()
