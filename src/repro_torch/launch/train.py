"""Training launcher of the port: ``--arch <id>`` trains a registered
recsys architecture's REDUCED (smoke) config on synthetic data, as the
JAX package's ``launch/train.py`` does. ``recsys_setup`` also builds a
published config's nets (``arch.make_config()``) for callers that give it
one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 --steps 50
    PYTHONPATH=src python -m repro_torch.launch.train --arch bst --device cpu

The default device is the card (``--device cuda``); without one the
launcher fails instead of training on the CPU. The LM and GNN archs are
not ported yet: they are named and refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.data.synthetic import make_recsys_batch
from repro_torch.models import recsys as rec_lib
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# the JAX launcher's LM and GNN archs (python -m repro.launch.train)
JAX_ONLY_ARCHS = ("command-r-plus-104b", "deepseek-v3-671b", "gin-tu",
                  "granite-moe-3b-a800m", "starcoder2-3b", "yi-9b")


def recsys_setup(arch, cfg, batch: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
    """(params, loss_fn, batch_fn) of a recsys arch at ``cfg`` (its smoke
    or its published config): the nets drawn from ``generator`` (default:
    one on ``device`` seeded 0), batches of ``batch`` made on the host
    from the step number and moved to ``device``."""
    dev = resolve_device(device)
    gen = generator or torch.Generator(device=dev).manual_seed(0)

    def put(d):
        return {k: torch.as_tensor(v, device=dev) for k, v in d.items()}

    if arch.name in ("dlrm-rm2", "dcn-v2"):
        init = rec_lib.dlrm_init if arch.name == "dlrm-rm2" else rec_lib.dcn_init
        fwd = (rec_lib.dlrm_forward if arch.name == "dlrm-rm2"
               else rec_lib.dcn_forward)
        params = init(gen, cfg, device=dev)

        def loss_fn(p, b):
            return rec_lib.bce_loss(fwd(p, b["dense"], b["sparse"], cfg),
                                    b["labels"])

        def batch_fn(step):
            return put(make_recsys_batch(batch, cfg.n_dense,
                                         cfg.cardinalities, seed=step))
    elif arch.name == "bst":
        params = rec_lib.bst_init(gen, cfg, device=dev)

        def loss_fn(p, b):
            return rec_lib.bce_loss(
                rec_lib.bst_forward(p, b["hist"], b["target"], cfg),
                b["labels"])

        def batch_fn(step):
            r = np.random.default_rng(step)
            return put({
                "hist": r.integers(0, cfg.n_items, (batch, cfg.seq_len)),
                "target": r.integers(0, cfg.n_items, batch),
                "labels": (r.random(batch) < 0.3).astype(np.float32)})
    elif arch.name == "bert4rec":
        params = rec_lib.bert4rec_init(gen, cfg, device=dev)
        n_masked = max(1, cfg.seq_len // 5)

        def loss_fn(p, b):
            return rec_lib.bert4rec_sampled_loss(
                p, b["items"], b["masked_pos"], b["labels"], b["negatives"],
                cfg)

        def batch_fn(step):
            r = np.random.default_rng(step)
            return put({
                "items": r.integers(1, cfg.n_items, (batch, cfg.seq_len)),
                "masked_pos": r.integers(0, cfg.seq_len, (batch, n_masked)),
                "labels": r.integers(1, cfg.n_items, (batch, n_masked)),
                "negatives": r.integers(1, cfg.n_items, 128)})
    else:
        raise ValueError(f"{arch.name!r} is not a recsys arch")
    return params, loss_fn, batch_fn


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True,
                    choices=sorted(list_archs() + list(JAX_ONLY_ARCHS)))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64,
                    help="sequence length of the LM archs (not ported yet)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default needs a CUDA card")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    args = build_parser().parse_args(argv)
    if args.arch in JAX_ONLY_ARCHS:
        raise SystemExit(f"[train] --arch {args.arch} is not ported yet (the "
                         f"JAX launcher, python -m repro.launch.train, has "
                         f"it; see ROADMAP.md)")
    dev = resolve_device(args.device)
    arch = get_arch(args.arch)
    params, loss_fn, batch_fn = recsys_setup(arch, arch.make_smoke_config(),
                                             args.batch, device=dev)
    tr = Trainer(loss_fn, params,
                 OptimizerConfig(lr=args.lr, total_steps=2 * args.steps),
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=max(10, args.steps),
                               ckpt_dir=args.ckpt_dir))
    if args.ckpt_dir:
        resumed = tr.maybe_restore()
        if resumed:
            print(f"[train] resumed at step {resumed}")
    t0 = time.time()
    m = tr.run(batch_fn)
    if not tr.history:
        print(f"[train] {args.arch}: nothing to run, the checkpoint is at "
              f"step {tr.start_step} of {args.steps}")
        return tr
    print(f"[train] {args.arch} on {dev}: loss {tr.history[0]['loss']:.4f} "
          f"-> {m['loss']:.4f} in {time.time() - t0:.1f}s "
          f"({args.steps} steps, smoke config)")
    return tr


if __name__ == "__main__":
    main()
