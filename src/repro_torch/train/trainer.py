"""Train-step factory and the fault-tolerant training loop: the JAX
package's ``train/trainer.py`` on PyTorch autograd.

``make_train_step`` builds the (params, opt, batch) -> (params, opt,
metrics) step: the loss's gradients by autograd (optionally summed in
float32 over microbatches, then divided by their count), global-norm
clip and AdamW, the parameters updated in place under ``torch.no_grad()``
(where the JAX step donates their buffers). ``Trainer`` adds periodic
atomic checkpoints, restart from LATEST and the straggler monitor.

The step takes no rules, as JAX's: the loss function closes over them
(``launch/steps.py``). DTensor params (a mesh) run the same step: the
backward runs under implicit replication, as the forward does, and
``adamw_update`` updates each rank's shards.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.ft.checkpoint import (latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.ft.straggler import StragglerMonitor
from repro_torch.sharding import tensors_scope
from repro_torch.train.optimizer import (AdamWState, OptimizerConfig,
                                         adamw_init, adamw_update)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    """(loss, grads) of ``loss_fn(params, batch)``; a parameter the loss
    does not use gets a zero gradient, as under ``jax.grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, batch)
    with tensors_scope(leaves):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    n_microbatches: int = 1):
    """loss_fn(params, batch) -> scalar loss. Returns the step function."""

    def step(params, opt_state: AdamWState, batch):
        if n_microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = n_microbatches
            loss = torch.zeros((), dtype=torch.float32,
                               device=opt_state.step.device)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            for i in range(n):
                mb = tree_map(lambda x: x.reshape(n, -1, *x.shape[1:])[i],
                              batch)
                l, g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(torch.add, grads, g)
                loss = loss + l
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    n_microbatches: int = 1
    keep_ckpts: int = 3


class Trainer:
    def __init__(self, loss_fn: Callable, params: Any,
                 opt_cfg: OptimizerConfig, cfg: TrainerConfig,
                 monitor: Optional[StragglerMonitor] = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.params = params
        self.opt_state = adamw_init(params, opt_cfg)
        self.step_fn = make_train_step(loss_fn, opt_cfg, cfg.n_microbatches)
        self.monitor = monitor or StragglerMonitor(n_hosts=1)
        self.history: list[Dict[str, float]] = []
        self.start_step = 0

    def maybe_restore(self) -> int:
        """Resume from LATEST if present, onto the parameters' device.
        Returns the resume step."""
        if self.cfg.ckpt_dir is None:
            return 0
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return 0
        state = restore_checkpoint(
            self.cfg.ckpt_dir, {"params": self.params, "opt": self.opt_state},
            device=self.opt_state.step.device)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.start_step = step
        return step

    def save(self, step: int) -> None:
        if self.cfg.ckpt_dir is None:
            return
        save_checkpoint(self.cfg.ckpt_dir, step,
                        {"params": self.params, "opt": self.opt_state})

    def run(self, batch_fn: Callable[[int], Any]) -> Dict[str, float]:
        """batch_fn(step) -> batch (deterministic in step: restart safe)."""
        metrics = {}
        for step in range(self.start_step, self.cfg.total_steps):
            t0 = time.perf_counter()
            batch = batch_fn(step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            float(metrics["loss"])              # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.record_step({0: dt})
            row = {k: float(v) for k, v in metrics.items()}
            row["step"] = step
            row["sec"] = dt
            self.history.append(row)
            if (step + 1) % self.cfg.ckpt_every == 0:
                self.save(step + 1)
        if self.cfg.total_steps % self.cfg.ckpt_every != 0:
            self.save(self.cfg.total_steps)
        return {k: float(v) for k, v in metrics.items()}
