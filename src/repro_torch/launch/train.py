"""Training launcher of the port: ``--arch <id>`` trains a registered
architecture's REDUCED (smoke) config on synthetic data, as the JAX
package's ``launch/train.py`` does: the LM family on token batches, GIN
on a 500-node graph, the recsys nets on CTR batches. ``lm_setup``,
``gnn_setup`` and ``recsys_setup`` also take a published config for
callers that give them one.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 --steps 50

The default device is the card (``--device cuda``); without one the
launcher fails instead of training on the CPU. DeepSeek-V3 is not ported
yet: it is named and refused.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, list_archs
from repro_torch.data.synthetic import (make_graph, make_recsys_batch,
                                        make_token_batch)
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

# the JAX launcher's archs not ported yet (python -m repro.launch.train)
JAX_ONLY_ARCHS = ("deepseek-v3-671b",)


def _put(d, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in d.items()}


def _generator(generator, dev):
    return generator or torch.Generator(device=dev).manual_seed(0)


def lm_setup(arch, cfg, batch: int, seq: int, device="cuda",
             generator: Optional[torch.Generator] = None):
    """(params, loss_fn, batch_fn) of a dense or MoE transformer at
    ``cfg``: the weights drawn from ``generator`` (default: one on
    ``device`` seeded 0), ``make_token_batch(batch, seq)`` from the step
    number, the next-token loss."""
    dev = resolve_device(device)
    params, _ = tf_lib.init_params(_generator(generator, dev), cfg,
                                   device=dev)

    def loss_fn(p, b):
        return tf_lib.lm_loss(p, b["tokens"], b["targets"], cfg)

    def batch_fn(step):
        t, y = make_token_batch(batch, seq, cfg.vocab_size, seed=step)
        return _put({"tokens": t, "targets": y}, dev)

    return params, loss_fn, batch_fn


def gnn_setup(arch, cfg, device="cuda",
              generator: Optional[torch.Generator] = None):
    """(params, loss_fn, batch_fn) of GIN at ``cfg``: node classification
    on ``make_graph(500, 4000)`` (seed 0, every step the same graph), the
    loss over its train mask."""
    dev = resolve_device(device)
    params, _ = gnn_lib.init_params(_generator(generator, dev), cfg,
                                    device=dev)
    g = make_graph(500, 4000, cfg.d_in, n_classes=cfg.n_classes, seed=0)
    graph = _put({"feats": g["feats"], "src": g["src"], "dst": g["dst"],
                  "labels": g["labels"],
                  "mask": g["train_mask"].astype(np.float32)}, dev)

    def loss_fn(p, b):
        return gnn_lib.node_classification_loss(
            p, b["feats"], b["src"], b["dst"], b["labels"], b["mask"], cfg)

    def batch_fn(step):
        return graph

    return params, loss_fn, batch_fn


def recsys_setup(arch, cfg, batch: int, device="cuda",
                 generator: Optional[torch.Generator] = None):
    """(params, loss_fn, batch_fn) of a recsys arch at ``cfg`` (its smoke
    or its published config): the nets drawn from ``generator`` (default:
    one on ``device`` seeded 0), batches of ``batch`` made on the host
    from the step number and moved to ``device``."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)

    def put(d):
        return _put(d, dev)

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
                    help="sequence length of the LM archs")
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
    cfg = arch.make_smoke_config()
    if arch.family == "lm":
        params, loss_fn, batch_fn = lm_setup(arch, cfg, args.batch,
                                             args.seq, device=dev)
    elif arch.family == "gnn":
        params, loss_fn, batch_fn = gnn_setup(arch, cfg, device=dev)
    else:
        params, loss_fn, batch_fn = recsys_setup(arch, cfg, args.batch,
                                                 device=dev)
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
