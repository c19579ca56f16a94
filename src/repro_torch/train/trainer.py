"""Fault-tolerant training loop, on one device or over a device mesh.

Responsibilities:
  * build the train step (``distributed.steps.make_train_step``),
  * deterministic data (stateless per-step addressing -> restart anywhere),
  * periodic preemption-safe checkpoints + automatic resume: every step
    is a function of (state, step index), so a crashed run resumes from
    the last published checkpoint and replays identically
    (``tests/test_torch_trainer.py`` holds the replay bit for bit).

Checkpoints hold ``(params, opt, step)`` as full tensors, whatever mesh
wrote them: restore puts them on the trainer's device and, over a
``DeviceMesh``, places them by ``train_state_specs`` for that mesh
(elastic restart = restart with another mesh).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.shapes import ShapeCell
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.distributed.steps import (_on_mesh, make_train_step,
                                           shard_state, train_state_specs)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import init_params, tree_map
from repro_torch.optim import adamw_init


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    lr: float = 3e-4
    grad_accum: int = 1
    seed: int = 0
    log_every: int = 10


class Trainer:
    """``param_dtype`` is the parameters' dtype (the AdamW moments are
    float32 whatever it is); ``device`` the device the state lives on
    (this rank's, over a mesh), the GPU unless given.  Over a
    ``DeviceMesh`` every rank builds the same Trainer; the state is DTensors
    placed by ``train_state_specs``."""

    def __init__(self, model_cfg, mesh, cell: ShapeCell, tcfg: TrainConfig,
                 param_dtype=torch.float32, device=None):
        self.cfg = model_cfg
        self.mesh = mesh
        self.cell = cell
        self.tcfg = tcfg
        self.param_dtype = param_dtype
        self.device = resolve_device(device)
        self.step_fn = make_train_step(model_cfg, mesh, cell, lr=tcfg.lr,
                                       grad_accum=tcfg.grad_accum)
        self._specs = (train_state_specs(model_cfg, mesh)
                       if _on_mesh(mesh, "Trainer") else None)
        self.data = SyntheticTokens(model_cfg.vocab, cell.seq_len,
                                    cell.global_batch, seed=tcfg.seed)
        self.params = None
        self.opt = None
        self.step = 0

    def init_or_restore(self) -> bool:
        """Resume from the latest checkpoint if one exists (a restarted
        job lands here and replays identically), else fresh parameters
        from ``torch.Generator`` seeded with ``tcfg.seed``."""
        if self.tcfg.ckpt_dir and latest_step(self.tcfg.ckpt_dir) is not None:
            like = tree_map(
                lambda pd: torch.empty(pd.shape, dtype=self.param_dtype,
                                       device=self.device),
                tf.pdefs(self.cfg))
            (params, opt, step), _ = restore_checkpoint(
                self.tcfg.ckpt_dir, (like, adamw_init(like), 0))
            self._place(params, opt)
            self.step = int(step)
            return True
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = init_params(tf.pdefs(self.cfg), gen, self.param_dtype,
                             self.device)
        self._place(params, adamw_init(params))
        self.step = 0
        return False

    def _place(self, params, opt) -> None:
        """Whole state (the same on every rank) as the trainer keeps it:
        as is on one device, placed by the specs over a mesh."""
        if self._specs is not None:
            params = shard_state(params, self._specs[0], self.mesh)
            opt = shard_state(opt, self._specs[1], self.mesh)
        self.params, self.opt = params, opt

    def _host_batch(self, step: int):
        tokens, targets = self.data.batch_at(step)
        return (torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(targets).to(self.device))

    def run(self, on_step: Optional[Callable[[int, Dict], None]] = None):
        metrics_hist = []
        t0 = time.time()
        while self.step < self.tcfg.steps:
            tokens, targets = self._host_batch(self.step)
            self.params, self.opt, m = self.step_fn(
                self.params, self.opt, tokens, targets)
            self.step += 1
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.steps:
                m = {k: float(v) for k, v in m.items()}
                m["step"] = self.step
                m["wall_s"] = round(time.time() - t0, 2)
                metrics_hist.append(m)
                if on_step:
                    on_step(self.step, m)
            if self.tcfg.ckpt_dir and (
                    self.step % self.tcfg.ckpt_every == 0
                    or self.step == self.tcfg.steps):
                save_checkpoint(self.tcfg.ckpt_dir, self.step,
                                (self.params, self.opt, self.step))
        return metrics_hist
