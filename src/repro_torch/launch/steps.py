"""Step builders: one (step_fn, abstract args, shardings) bundle per
(architecture x input shape x mesh) cell of the dry-run matrix, the
port's counterpart of the JAX package's ``launch/steps.py``.

Every argument is a tensor on the ``meta`` device, in the JAX package's
tree layout (params, AdamW state, batch dict; params, cache, tokens, pos;
...): nothing is drawn or allocated, so a 671B config costs nothing to
describe, and the step runs on those tensors as it would on real ones
(``launch/dryrun.py`` traces it there). ``materialize`` draws real
arguments of a job on a device, and the same step then runs there.

Every builder takes ``mesh=`` (a ``DeviceMesh``; JAX's ``build_job(arch,
shape, mesh, variant)``). With a mesh the job carries JAX's
``in_shardings`` as spec trees (``in_specs``, one per argument, the
argument's tree of ``sharding.P``) and its ``out_shardings`` where JAX
names them (``out_specs``, with ``out_like``: the outputs' meta tensors;
None where JAX leaves them to the compiler), and the step closes over the
mesh's rules with JAX's overrides: ``fsdp`` (``embed`` on data),
``shardnodes`` (``nodes`` on the batch axes), ``repltable``
(``table_rows`` replicated), DeepSeek's EP override, the prefill cache's
and the decode step's ``kv_seq`` / batch rules, the retrieval rules over
the corpus axes. ``moe_groups`` is the mesh's batch axes' size and the
``guitar-serve`` partition count its ``model`` axis. Without a mesh
(``mesh=None``: one card) there are no specs, the rules are None, the
batch and corpus axes count 1, and the sharding-only variants change
nothing; a (1, 1) mesh gives the same arguments. ``microbatchN``
(``train.trainer.make_train_step``), ``w8`` (weights stored in
``torch.float8_e4m3fn``), ``bf16`` / ``bf16model`` (GIN messages or the
whole GIN in bf16) and ``sl2g`` change the step as in JAX; the
``moe_impl="ep"`` of the MoE train and prefill cells runs ``moe_ffn_ep``
under a mesh and ``moe_ffn`` without one.
- Train steps update params and moments in place (JAX donates args 0 and
  1), a decode step its cache (JAX donates arg 1): ``donate`` names them.
- The ``guitar-serve`` step is ``core.make_sharded_search`` with the
  measure's bundle (``meta=("deepfm", fm_dim)``), so on the card it runs
  the port's kernels; JAX passes ``meta=None`` there, because its dry run
  lowers on fake CPU devices where no Pallas kernel lowers.

``build_lm_job`` and ``build_job`` also take ``n_layers``: the LM stack
cut to that depth with the published widths (DeepSeek keeps up to its
three dense layers and cuts the MoE ones), for a dry run at a cut depth.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchDef, ShapeSpec, get_arch
from repro_torch.launch.mesh import batch_axis_size
from repro_torch.models import deepseek as ds_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import layers as L
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.sharding import (P, mesh_axis_sizes, mesh_rules,
                                  specs_for_tree, zero1_spec_tree)
from repro_torch.train.optimizer import (AdamWState, OptimizerConfig,
                                         adamw_init)
from repro_torch.train.trainer import make_train_step
from repro_torch.tree import flatten_with_paths, tree_map, tree_unflatten

META = torch.device("meta")


@dataclasses.dataclass
class StepJob:
    """One cell: ``step_fn(*args)``, ``args`` as meta tensors. ``init``
    draws the params on a device ((generator, device) -> params); ``inputs``
    maps a path of ``flatten_with_paths(args)`` (or a prefix of one) to
    how ``materialize`` draws that leaf (see ``_draw``); a float leaf it
    does not name is drawn from N(0, 1)."""
    name: str
    arch: str
    shape: str
    step_fn: Callable
    args: Tuple[Any, ...]
    static_meta: dict
    donate: Tuple[int, ...] = ()
    init: Optional[Callable] = None
    inputs: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    mesh: Any = None
    in_specs: Optional[Tuple[Any, ...]] = None
    out_specs: Any = None
    out_like: Any = None


def _pad_count(n: int, m: int = 512) -> int:
    """Pad a sharded leading dim so it divides both production meshes
    (single 16x16 and multi 2x16x16 -> lcm-safe at 512)."""
    return ((n + m - 1) // m) * m


def _abstract_init(init_fn, cfg):
    """(params, axes) on ``meta``: shapes and dtypes, nothing drawn (axes
    None for an init that returns the params alone)."""
    out = init_fn(torch.Generator(), cfg, device=META)
    if isinstance(out, tuple):
        return out
    return out, None


def _sds(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def _repl_like(tree):
    """P() for every leaf of ``tree`` (JAX's replicated sharding)."""
    return tree_map(lambda _: P(), tree)


def _batch_spec(mesh) -> P:
    return P(tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names))


def _rules_of(mesh):
    return None if mesh is None else mesh_rules(mesh)


def _specs(axes, rules):
    return None if rules is None else specs_for_tree(axes, rules)


def _opt_specs(params, axes, mesh, rules):
    """JAX's ``_opt_shardings``: a replicated step, ZeRO-1 moments."""
    if rules is None:
        return None
    z = zero1_spec_tree(params, axes, mesh, rules)
    return AdamWState(step=P(), m=z, v=z)


def _leading(batch: dict, B: int, lead: P) -> dict:
    """JAX's batch shardings: a leaf whose leading dim is the batch B on
    the batch axes, any other replicated."""
    return {k: P(lead[0], *([None] * (v.dim() - 1)))
            if v.dim() and v.shape[0] == B else P()
            for k, v in batch.items()}


def _cut_depth(cfg, n_layers: Optional[int]):
    if not n_layers:
        return cfg
    if isinstance(cfg, ds_lib.DeepSeekConfig):
        return dataclasses.replace(
            cfg, n_layers=n_layers,
            n_dense_layers=min(cfg.n_dense_layers, max(n_layers - 1, 0)))
    return dataclasses.replace(cfg, n_layers=n_layers)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def _lm_modules(arch: ArchDef):
    if arch.name.startswith("deepseek"):
        return ds_lib
    return tf_lib


def _lm_opt_cfg(arch: ArchDef) -> OptimizerConfig:
    # 671B fp32 moments exceed one pod's HBM — bf16 moments for deepseek
    mdt = torch.bfloat16 if arch.name.startswith("deepseek") \
        else torch.float32
    return OptimizerConfig(lr=3e-4, moment_dtype=mdt)


def _lm_model_flops(cfg, tokens: int, decode: bool = False,
                    kv_len: int = 0) -> float:
    """6·N_active·D for train, 2·N_active·D per decoded token (+attention)."""
    if isinstance(cfg, ds_lib.DeepSeekConfig):
        d = cfg.d_model
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads *
                (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
                + d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
                + cfg.kv_lora_rank * cfg.n_heads *
                (cfg.qk_nope_head_dim + cfg.v_head_dim)
                + cfg.n_heads * cfg.v_head_dim * d)
        dense_ffn = 3 * d * cfg.dense_d_ff
        moe_ffn = 3 * d * cfg.moe_d_ff * (cfg.moe_top_k + cfg.n_shared_experts)
        n_active = (cfg.n_dense_layers * (attn + dense_ffn)
                    + (cfg.n_layers - cfg.n_dense_layers) * (attn + moe_ffn)
                    + 2 * cfg.vocab_size * d)
    else:
        d, hd = cfg.d_model, cfg.head_dim
        attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd + cfg.n_heads * hd * d
        if cfg.is_moe:
            ffn = 3 * d * cfg.moe_d_ff * cfg.moe_top_k
        elif cfg.mlp_type == "swiglu":
            ffn = 3 * d * cfg.d_ff
        else:
            ffn = 2 * d * cfg.d_ff
        n_active = cfg.n_layers * (attn + ffn) + 2 * cfg.vocab_size * d
    factor = 2 if decode else 6
    flops = factor * n_active * tokens
    if decode and kv_len:
        # attention reads: 2·2·L·kv·heads... dominated by score+value matmuls
        if isinstance(cfg, ds_lib.DeepSeekConfig):
            per_tok = (2 * cfg.n_layers * cfg.n_heads * kv_len *
                       (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2)
        else:
            per_tok = 2 * cfg.n_layers * cfg.n_heads * kv_len * cfg.head_dim * 2
        flops += per_tok * tokens
    return float(flops)


# a train step's AdamW state (arg 1) starts at zero
OPT_ZEROS = {"1": ("zeros",)}


def build_lm_job(arch: ArchDef, shape: ShapeSpec, variant: str = "base",
                 n_layers: Optional[int] = None, mesh=None) -> StepJob:
    mod = _lm_modules(arch)
    cfg = _cut_depth(arch.make_config(), n_layers)
    rules = _rules_of(mesh)
    nb = 1 if mesh is None else batch_axis_size(mesh)
    if hasattr(cfg, "moe_groups") and getattr(cfg, "n_experts", 0):
        cfg = dataclasses.replace(cfg, moe_groups=nb)
    if rules is not None:
        sizes = mesh_axis_sizes(mesh)
        if getattr(cfg, "n_experts", 0) >= sizes["data"] * sizes["model"]:
            # fine-grained MoE (deepseek: 256e): one expert per intra-pod
            # device, replicated across pods; capacity unsharded
            rules = rules.with_overrides(experts=("data", "model"),
                                         capacity=None)
        if "fsdp" in variant:
            # 2-D weight sharding (FSDP x TP): the embed weight dim on data
            rules = rules.with_overrides(embed="data")
    B, S = shape["batch"], shape["seq"]
    if shape.kind in ("train", "prefill") and S >= 2048:
        # flash-style chunked attention: bounds the (B,H,c,T) logits buffer
        cfg = dataclasses.replace(cfg, attn_chunk=1024)
    if shape.kind in ("train", "prefill") and getattr(cfg, "n_experts", 0):
        # the all-to-all EP dispatch (moe_ffn_ep) under a mesh
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    name = f"{arch.name}:{shape.name}"
    vocab = ("int", 0, cfg.vocab_size)
    bspec = None if mesh is None else _batch_spec(mesh)
    common = dict(name=name, arch=arch.name, shape=shape.name, mesh=mesh)

    if shape.kind == "train":
        params, axes = _abstract_init(mod.init_params, cfg)
        opt_cfg = _lm_opt_cfg(arch)
        opt = adamw_init(params, opt_cfg)
        batch = {"tokens": _sds((B, S), torch.int32),
                 "targets": _sds((B, S), torch.int32)}
        # perf variants: microbatchN = N-way gradient accumulation
        m = re.search(r"microbatch(\d+)", variant)
        n_micro = int(m.group(1)) if m else 1

        def loss_fn(p, b):
            return mod.lm_loss(p, b["tokens"], b["targets"], cfg, rules)

        psp = _specs(axes, rules)
        osp = _opt_specs(params, axes, mesh, rules)
        return StepJob(
            step_fn=make_train_step(loss_fn, opt_cfg, n_micro),
            args=(params, opt, batch),
            static_meta={"model_flops": _lm_model_flops(cfg, B * S),
                         "tokens": B * S, "kind": "train"},
            donate=(0, 1), init=_init_of(mod.init_params, cfg),
            inputs={**OPT_ZEROS, "2/tokens": vocab, "2/targets": vocab},
            in_specs=None if rules is None else (
                psp, osp, {k: P(bspec[0], None) for k in batch}),
            out_specs=None if rules is None else (psp, osp, None),
            **common)

    if shape.kind == "prefill":
        params, axes = _abstract_init(mod.init_params, cfg)
        batch = {"tokens": _sds((B, S), torch.int32)}

        def step(params, batch):
            return mod.prefill(params, batch["tokens"], cfg, rules)

        specs = {}
        if rules is not None:
            # the prefill cache lands in the decode layout: kv_seq on model
            pc_rules = rules.with_overrides(kv_seq="model")
            cache_ax = mod.cache_axes() if mod is ds_lib \
                else tf_lib.cache_axes()
            specs = dict(
                in_specs=(_specs(axes, rules), {"tokens": P(bspec[0], None)}),
                out_specs=(P(bspec[0], "model"),
                           specs_for_tree(cache_ax, pc_rules)),
                out_like=(_sds((B, L.pad_vocab(cfg.vocab_size)), cfg.dtype),
                          mod.init_cache(cfg, B, S, dtype=cfg.dtype,
                                         device=META)))
        return StepJob(
            step_fn=step, args=(params, batch),
            static_meta={"model_flops": _lm_model_flops(cfg, B * S) / 3,
                         "tokens": B * S, "kind": "prefill"},
            init=_init_of(mod.init_params, cfg), inputs={"1/tokens": vocab},
            **specs, **common)

    # decode: one new token against a seq-length cache
    if "w8" in variant and not getattr(cfg, "n_experts", 0) \
            and hasattr(cfg, "param_dtype"):
        # weight-only fp8 serving: weights stored f8_e4m3, cast to bf16 at
        # use — halves the weight-read bytes that dominate decode
        cfg = dataclasses.replace(cfg, param_dtype=torch.float8_e4m3fn)
    params, axes = _abstract_init(mod.init_params, cfg)
    cache = mod.init_cache(cfg, B, S, device=META)
    dec_rules, specs = None, {}
    if rules is not None:
        dec_rules = rules.with_overrides(
            act_seq=None,   # single-token steps: nothing to sequence-shard
            kv_seq=("data", "model") if B == 1 else "model",
            **({"batch": None, "queries": None} if B == 1 else {}))
        cache_ax = mod.cache_axes() if mod is ds_lib \
            else tf_lib.cache_axes()
        csp = specs_for_tree(cache_ax, dec_rules)
        specs = dict(in_specs=(specs_for_tree(axes, dec_rules), csp,
                               P(None) if B == 1 else P(bspec[0]), P()),
                     out_specs=(None, csp))

    def step(params, cache, tokens, pos):
        return mod.decode_step(params, cache, tokens, pos, cfg, dec_rules)

    return StepJob(
        step_fn=step,
        args=(params, cache, _sds((B,), torch.int32), _sds((), torch.int32)),
        static_meta={"model_flops": _lm_model_flops(cfg, B, decode=True,
                                                    kv_len=S),
                     "tokens": B, "kind": "decode"},
        donate=(1,), init=_init_of(mod.init_params, cfg),
        # the token at the cache's last slot: a step against a full cache
        inputs={"2": vocab, "3": ("value", S - 1)}, **specs, **common)


def _init_of(init_fn, cfg):
    """(generator, device) -> the params ``init_fn`` draws for ``cfg``."""
    def init(generator, device):
        out = init_fn(generator, cfg, device=device)
        return out[0] if isinstance(out, tuple) else out
    return init


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------

def build_gnn_job(arch: ArchDef, shape: ShapeSpec,
                  variant: str = "base", mesh=None) -> StepJob:
    cfg = arch.make_config(shape)
    rules = _rules_of(mesh)
    # perf variants: bf16 message aggregation / node-sharded aggregation /
    # bf16 feature storage
    if "bf16model" in variant:
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    elif "bf16" in variant:
        cfg = dataclasses.replace(cfg, msg_bf16=True)
    if "shardnodes" in variant and rules is not None:
        rules = rules.with_overrides(nodes=_batch_spec(mesh)[0])
    params, axes = _abstract_init(gnn_lib.init_params, cfg)
    opt_cfg = OptimizerConfig(lr=1e-3)
    opt = adamw_init(params, opt_cfg)
    classes = ("int", 0, cfg.n_classes)

    if shape.name == "molecule":
        G, Nn, Ne = shape["batch"], shape["n_nodes"], shape["n_edges"]
        batch = {
            "feats": _sds((G * Nn, shape["d_feat"]), torch.float32),
            "src": _sds((G * Ne,), torch.int32),
            "dst": _sds((G * Ne,), torch.int32),
            "graph_ids": _sds((G * Nn,), torch.int32),
            "labels": _sds((G,), torch.int32),
        }
        inputs = {"2/src": ("int", 0, G * Nn), "2/dst": ("int", 0, G * Nn),
                  "2/graph_ids": ("blocks", Nn), "2/labels": classes}

        def loss_fn(p, b):
            return gnn_lib.graph_classification_loss(
                p, b["feats"], b["src"], b["dst"], b["graph_ids"], G,
                b["labels"], cfg, rules=rules)
        flops = 2.0 * (G * Ne * cfg.d_hidden * cfg.n_layers * 2
                       + G * Nn * (shape["d_feat"] * cfg.d_hidden
                                   + (cfg.n_layers * 2 - 1) * cfg.d_hidden ** 2)) * 3
    else:
        if shape.name == "minibatch_lg":
            Nn, Ne = shape["max_nodes"], shape["max_edges"]
            n_real = Ne
        else:
            # edge arrays padded as JAX pads them to shard evenly; the
            # padding points at node 0 and is masked out
            Nn, Ne = shape["n_nodes"], _pad_count(shape["n_edges"])
            n_real = shape["n_edges"]
        batch = {
            "feats": _sds((Nn, shape["d_feat"]), torch.float32),
            "src": _sds((Ne,), torch.int32),
            "dst": _sds((Ne,), torch.int32),
            "labels": _sds((Nn,), torch.int32),
            "label_mask": _sds((Nn,), torch.float32),
            "edge_mask": _sds((Ne,), torch.float32),
        }
        inputs = {"2/src": ("edges", Nn, n_real),
                  "2/dst": ("edges", Nn, n_real), "2/labels": classes,
                  "2/label_mask": ("mask",),
                  "2/edge_mask": ("prefix", n_real)}

        def loss_fn(p, b):
            return gnn_lib.node_classification_loss(
                p, b["feats"], b["src"], b["dst"], b["labels"],
                b["label_mask"], cfg, edge_mask=b["edge_mask"], rules=rules)
        flops = 2.0 * (Ne * cfg.d_hidden * cfg.n_layers * 2
                       + Nn * (shape["d_feat"] * cfg.d_hidden
                               + (cfg.n_layers * 2 - 1) * cfg.d_hidden ** 2)) * 3

    specs = {}
    if rules is not None:
        psp = _specs(axes, rules)
        osp = _opt_specs(params, axes, mesh, rules)
        edges = P(_batch_spec(mesh)[0])
        bsp = {k: edges if k in ("src", "dst", "edge_mask") else P()
               for k in batch}
        specs = dict(in_specs=(psp, osp, bsp), out_specs=(psp, osp, None))
    return StepJob(
        name=f"{arch.name}:{shape.name}", arch=arch.name, shape=shape.name,
        step_fn=make_train_step(loss_fn, opt_cfg), args=(params, opt, batch),
        static_meta={"model_flops": flops, "kind": "train"}, donate=(0, 1),
        init=_init_of(gnn_lib.init_params, cfg),
        inputs={**OPT_ZEROS, **inputs}, mesh=mesh, **specs)


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def _recsys_init(arch: ArchDef, cfg):
    return {
        "dlrm-rm2": rec_lib.dlrm_init,
        "dcn-v2": rec_lib.dcn_init,
        "bst": rec_lib.bst_init,
        "bert4rec": rec_lib.bert4rec_init,
    }[arch.name]


def _recsys_train_batch(arch: ArchDef, cfg, B: int):
    if arch.name in ("dlrm-rm2", "dcn-v2"):
        return {"dense": _sds((B, cfg.n_dense), torch.float32),
                "sparse": _sds((B, cfg.n_sparse), torch.int32),
                "labels": _sds((B,), torch.float32)}
    if arch.name == "bst":
        return {"hist": _sds((B, cfg.seq_len), torch.int32),
                "target": _sds((B,), torch.int32),
                "labels": _sds((B,), torch.float32)}
    n_masked = max(1, cfg.seq_len // 5)
    return {"items": _sds((B, cfg.seq_len), torch.int32),
            "masked_pos": _sds((B, n_masked), torch.int32),
            "labels": _sds((B, n_masked), torch.int32),
            "negatives": _sds((1024,), torch.int32)}


def _recsys_inputs(arch: ArchDef, cfg, prefix: str) -> dict:
    """How ``materialize`` draws each batch leaf: ids below each table's
    rows (per field for the Criteo tables; item ids from 1, 0 being BERT4Rec's
    padding), 0/1 labels."""
    if arch.name in ("dlrm-rm2", "dcn-v2"):
        cards = tuple(int(c) for c in cfg.cardinalities)
        offs = tuple(int(o) for o in rec_lib.field_offsets(cards))
        n_user = cfg.n_sparse - cfg.n_item_fields
        return {
            f"{prefix}/sparse": ("ranges", (0,) * len(cards), cards),
            f"{prefix}/labels": ("mask",),
            # retrieval: the user's fields as rows of the one table
            f"{prefix}/user_sparse": ("ranges", offs[:n_user], tuple(
                o + c for o, c in zip(offs[:n_user], cards[:n_user])))}
    if arch.name == "bst":
        items = ("int", 0, cfg.n_items)
        return {f"{prefix}/hist": items, f"{prefix}/target": items,
                f"{prefix}/cand": items, f"{prefix}/labels": ("mask",)}
    items = ("int", 1, cfg.n_items)
    return {f"{prefix}/items": items, f"{prefix}/labels": items,
            f"{prefix}/negatives": items, f"{prefix}/cand": items,
            f"{prefix}/masked_pos": ("int", 0, cfg.seq_len)}


def _recsys_axes(arch: ArchDef, cfg):
    return {
        "dlrm-rm2": rec_lib.dlrm_axes,
        "dcn-v2": rec_lib.dcn_axes,
        "bst": rec_lib.bst_axes,
        "bert4rec": rec_lib.bert4rec_axes,
    }[arch.name](cfg)


def _recsys_loss(arch: ArchDef, cfg, rules=None):
    if arch.name == "dlrm-rm2":
        def f(p, b):
            lg = rec_lib.dlrm_forward(p, b["dense"], b["sparse"], cfg, rules)
            return rec_lib.bce_loss(lg, b["labels"])
    elif arch.name == "dcn-v2":
        def f(p, b):
            lg = rec_lib.dcn_forward(p, b["dense"], b["sparse"], cfg, rules)
            return rec_lib.bce_loss(lg, b["labels"])
    elif arch.name == "bst":
        def f(p, b):
            lg = rec_lib.bst_forward(p, b["hist"], b["target"], cfg, rules)
            return rec_lib.bce_loss(lg, b["labels"])
    else:
        def f(p, b):
            return rec_lib.bert4rec_sampled_loss(
                p, b["items"], b["masked_pos"], b["labels"], b["negatives"],
                cfg, rules)
    return f


def _recsys_flops(arch: ArchDef, cfg, B: int, train: bool) -> float:
    mult = 6 if train else 2
    if arch.name == "dlrm-rm2":
        bot = sum(a * b for a, b in zip((cfg.n_dense,) + cfg.bot_mlp[:-1], cfg.bot_mlp))
        n_vec = cfg.n_sparse + 1
        inter = n_vec * n_vec * cfg.embed_dim
        tin = n_vec * (n_vec - 1) // 2 + cfg.embed_dim
        top = sum(a * b for a, b in zip((tin,) + cfg.top_mlp[:-1], cfg.top_mlp))
        return float(mult * B * (bot + inter + top))
    if arch.name == "dcn-v2":
        d = cfg.d_input
        cross = cfg.n_cross_layers * d * d
        deep = sum(a * b for a, b in zip((d,) + cfg.deep_mlp[:-1], cfg.deep_mlp))
        return float(mult * B * (cross + deep + d + cfg.deep_mlp[-1]))
    if arch.name == "bst":
        S, d = cfg.seq_len + 1, cfg.embed_dim
        blk = cfg.n_blocks * (4 * d * d * S + 2 * S * S * d + 8 * d * d * S)
        dflat = S * d
        mlp = sum(a * b for a, b in zip((dflat,) + cfg.mlp[:-1], cfg.mlp)) + cfg.mlp[-1]
        return float(mult * B * (blk + mlp))
    S, d = cfg.seq_len, cfg.embed_dim
    blk = cfg.n_blocks * (4 * d * d * S + 2 * S * S * d + 8 * d * d * S)
    return float(mult * B * blk)


def _bert4rec_retrieval_flops(cfg, N: int) -> float:
    """Two-tower: encode the user once + one dot per candidate."""
    S, d = cfg.seq_len, cfg.embed_dim
    blk = cfg.n_blocks * (4 * d * d * S + 2 * S * S * d + 8 * d * d * S)
    return float(2 * blk + 2 * N * d)


def build_recsys_job(arch: ArchDef, shape: ShapeSpec,
                     variant: str = "base", mesh=None) -> StepJob:
    cfg = arch.make_config()
    rules = _rules_of(mesh)
    # perf variant: replicate the embedding table (serving-size tables fit
    # per chip; no cross-shard gather on the hot path)
    if "repltable" in variant and rules is not None:
        rules = rules.with_overrides(table_rows=None)
    init_fn = _recsys_init(arch, cfg)
    params, _ = _abstract_init(init_fn, cfg)
    axes = _recsys_axes(arch, cfg)
    psp = _specs(axes, rules)
    bspec = None if mesh is None else _batch_spec(mesh)
    B = shape["batch"]
    name = f"{arch.name}:{shape.name}"
    common = dict(name=name, arch=arch.name, shape=shape.name,
                  init=_init_of(init_fn, cfg), mesh=mesh)

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(lr=1e-3)
        batch = _recsys_train_batch(arch, cfg, B)
        specs = {}
        if rules is not None:
            osp = _opt_specs(params, axes, mesh, rules)
            specs = dict(in_specs=(psp, osp, _leading(batch, B, bspec)),
                         out_specs=(psp, osp, None))
        return StepJob(
            step_fn=make_train_step(_recsys_loss(arch, cfg, rules), opt_cfg),
            args=(params, adamw_init(params, opt_cfg), batch),
            static_meta={"model_flops": _recsys_flops(arch, cfg, B, True),
                         "kind": "train"}, donate=(0, 1),
            inputs={**OPT_ZEROS, **_recsys_inputs(arch, cfg, "2")},
            **specs, **common)

    if shape.kind == "serve":
        batch = _recsys_train_batch(arch, cfg, B)
        batch.pop("labels", None)
        if arch.name == "bert4rec":
            batch.pop("masked_pos", None)
            batch.pop("negatives", None)

        if arch.name in ("dlrm-rm2", "dcn-v2"):
            fwd = rec_lib.dlrm_forward if arch.name == "dlrm-rm2" \
                else rec_lib.dcn_forward

            def step(params, batch):
                return fwd(params, batch["dense"], batch["sparse"], cfg,
                           rules)
        elif arch.name == "bst":
            def step(params, batch):
                return rec_lib.bst_forward(params, batch["hist"],
                                           batch["target"], cfg, rules)
        else:
            def step(params, batch):
                h = rec_lib.bert4rec_encode(params, batch["items"], cfg,
                                            rules)
                return h[:, -1, :]   # serving representation

        specs = {} if rules is None else dict(in_specs=(psp, {
            k: P(bspec[0], *([None] * (v.dim() - 1)))
            for k, v in batch.items()}))
        return StepJob(
            step_fn=torch.no_grad()(step), args=(params, batch),
            static_meta={"model_flops": _recsys_flops(arch, cfg, B, False),
                         "kind": "serve"},
            inputs=_recsys_inputs(arch, cfg, "1"), **specs, **common)

    # retrieval: 1 query x 1e6 candidates (padded as JAX pads them to shard
    # evenly; the pad tail's scores are sliced off by the caller)
    N = _pad_count(shape["n_candidates"])
    r_rules, corpus = None, None
    if rules is not None:
        corpus = tuple(a for a in ("pod", "data", "model")
                       if a in mesh.mesh_dim_names)
        # candidate-batch activations live on the corpus axes, not the
        # training batch axes
        r_rules = rules.with_overrides(corpus=corpus, batch=corpus)
    if arch.name in ("dlrm-rm2", "dcn-v2"):
        score_fn = (rec_lib.dlrm_score_candidates if arch.name == "dlrm-rm2"
                    else rec_lib.dcn_score_candidates)
        n_item = cfg.n_item_fields
        batch = {"dense": _sds((cfg.n_dense,), torch.float32),
                 "user_sparse": _sds((cfg.n_sparse - n_item,), torch.int32),
                 "cand_emb": _sds((N, n_item, cfg.embed_dim), torch.float32)}
        bsp = {"dense": P(), "user_sparse": P(),
               "cand_emb": P(corpus, None, None)}

        def step(params, batch):
            return score_fn(params, batch["dense"], batch["user_sparse"],
                            batch["cand_emb"], cfg, r_rules)
    elif arch.name == "bst":
        batch = {"hist": _sds((cfg.seq_len,), torch.int32),
                 "cand": _sds((N,), torch.int32)}
        bsp = {"hist": P(), "cand": P(corpus)}

        def step(params, batch):
            return rec_lib.bst_score_candidates(params, batch["hist"],
                                                batch["cand"], cfg, r_rules)
    else:
        batch = {"items": _sds((1, cfg.seq_len), torch.int32),
                 "cand": _sds((N,), torch.int32)}
        bsp = {"items": P(), "cand": P(corpus)}

        def step(params, batch):
            return rec_lib.bert4rec_score_candidates(
                params, batch["items"], batch["cand"], cfg, r_rules)

    mflops = (_bert4rec_retrieval_flops(cfg, N) if arch.name == "bert4rec"
              else _recsys_flops(arch, cfg, N, False))
    specs = {} if rules is None else dict(
        in_specs=(psp, bsp), out_specs=P(corpus),
        out_like=_sds((N,), torch.float32))
    return StepJob(
        step_fn=torch.no_grad()(step), args=(params, batch),
        static_meta={"model_flops": mflops, "kind": "retrieval"},
        inputs=_recsys_inputs(arch, cfg, "1"), **specs, **common)


# ---------------------------------------------------------------------------

def build_guitar_serve_job(variant: str = "base",
                           n_items: int = 1_048_576, n_queries: int = 4096,
                           degree: int = 48, mesh=None) -> StepJob:
    """The paper's own serving step as a cell: corpus-sharded GUITAR search
    (per-shard search + global top-k merge) over a Twitch-scale corpus with
    the DeepFM measure. Variant 'sl2g' runs the evaluate-all baseline.
    ``materialize`` draws the corpus from N(0, 1) and builds each shard's
    graph with ``graph.build_l2_graph`` (M = degree / 2)."""
    from repro_torch.configs.guitar_deepfm import measure_config
    from repro_torch.core.engine import SearchConfig
    from repro_torch.core.sharded import make_sharded_search
    from repro_torch.models import deepfm as deepfm_lib

    mcfg = measure_config()
    mparams, _ = _abstract_init(deepfm_lib.init_measure, mcfg)

    def score_fn(p, x, q):
        return deepfm_lib.score(p, x, q, mcfg)

    mode = "sl2g" if "sl2g" in variant else "guitar"
    scfg = SearchConfig(k=10, ef=64, budget=8, alpha=1.01, mode=mode)
    # one corpus partition per device of the mesh's model axis
    Pn = 1 if mesh is None else mesh_axis_sizes(mesh)["model"]
    Np = n_items // Pn
    D = mcfg.vec_dim
    args = (
        mparams,
        _sds((Pn, Np, D), torch.float32),          # base shards
        _sds((Pn, Np, degree), torch.int32),       # neighbor shards
        _sds((Pn,), torch.int32),                  # entries
        _sds((Pn, Np), torch.int32),               # global ids
        _sds((n_queries, D), torch.float32),       # queries
    )
    fn = make_sharded_search(score_fn, scfg, meta=("deepfm", mcfg.fm_dim))
    # cost model: per expansion 2F (grad) + C·F (evals); iters ≈ 2·ef
    F = 2 * (64 * 64 + 64 * 64 + 64 + mcfg.fm_dim)
    iters = 2 * scfg.ef
    per_q = iters * (2 + (scfg.budget if mode == "guitar" else degree)) * F
    specs = {}
    if mesh is not None:
        specs = dict(in_specs=(_repl_like(mparams), P("model", None, None),
                               P("model", None, None), P("model"),
                               P("model", None),
                               P(_batch_spec(mesh)[0], None)))
    return StepJob(
        name=f"guitar-serve:{mode}", arch="guitar-serve", shape=mode,
        step_fn=fn, args=args,
        static_meta={"model_flops": float(per_q * n_queries * Pn),
                     "kind": "serve",
                     "note": "corpus-sharded search; per-shard sub-search"},
        init=_init_of(deepfm_lib.init_measure, mcfg),
        inputs={"1": ("graph", degree // 2)}, mesh=mesh, **specs)


def build_job(arch_name: str, shape_name: str, variant: str = "base",
              n_layers: Optional[int] = None, mesh=None) -> StepJob:
    """The cell's job; ``mesh`` (a DeviceMesh) gives it JAX's shardings."""
    if arch_name == "guitar-serve":
        # shape selects the searcher: 'guitar' (gradient-pruned) or 'sl2g'
        return build_guitar_serve_job(variant=shape_name, mesh=mesh)
    arch = get_arch(arch_name)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return build_lm_job(arch, shape, variant, n_layers=n_layers,
                            mesh=mesh)
    if arch.family == "gnn":
        return build_gnn_job(arch, shape, variant, mesh=mesh)
    return build_recsys_job(arch, shape, variant, mesh=mesh)


def list_cells() -> list:
    """Every (arch, shape) of the matrix: each registered arch's shapes,
    then the two ``guitar-serve`` cells."""
    from repro_torch.configs import list_archs
    return ([(a, s.name) for a in list_archs() for s in get_arch(a).shapes]
            + [("guitar-serve", "guitar"), ("guitar-serve", "sl2g")])


# ---------------------------------------------------------------------------
# Real arguments
# ---------------------------------------------------------------------------

def input_spec(job: StepJob, path: str) -> Optional[tuple]:
    """The draw spec of the leaf at ``path`` (its own or its longest named
    prefix's), or None."""
    best = None
    for key, spec in job.inputs.items():
        if path == key or path.startswith(key + "/"):
            if best is None or len(key) > len(best[0]):
                best = (key, spec)
    return None if best is None else best[1]


def _draw(spec, like: torch.Tensor, gen: torch.Generator,
          dev: torch.device) -> torch.Tensor:
    """A leaf of ``like``'s shape and dtype on ``dev`` drawn from ``gen``:

    - None (a float leaf): N(0, 1); ``("zeros",)``; ``("value", v)``;
    - ``("int", lo, hi)``: uniform ids in [lo, hi);
    - ``("ranges", lo, hi)``: along the last axis, column j in [lo[j], hi[j]);
    - ``("mask",)``: 0/1 at one half each; ``("prefix", n)``: 1 for the
      first n entries, 0 after;
    - ``("edges", n_nodes, n_real)``: ids below n_nodes for the first
      n_real entries, node 0 after (padding);
    - ``("blocks", n)``: entry i is i // n (node i's graph)."""
    shape, dtype = tuple(like.shape), like.dtype
    kind = spec[0] if spec else ("normal" if dtype.is_floating_point
                                 else "zeros")
    if kind == "normal":
        return torch.empty(shape, dtype=dtype, device=dev).normal_(
            generator=gen)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if kind == "value":
        return torch.full(shape, spec[1], dtype=dtype, device=dev)
    if kind == "int":
        return torch.randint(spec[1], spec[2], shape, generator=gen,
                             device=dev).to(dtype)
    if kind == "ranges":
        lo = torch.as_tensor(spec[1], dtype=torch.int64, device=dev)
        span = torch.as_tensor(spec[2], dtype=torch.int64, device=dev) - lo
        u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
        return (lo + (u * span).long().clamp_max(span - 1)).to(dtype)
    if kind == "mask":
        return (torch.rand(shape, generator=gen, device=dev) < 0.5).to(dtype)
    if kind == "prefix":
        return (torch.arange(shape[0], device=dev) < spec[1]).to(dtype)
    if kind == "edges":
        ids = torch.randint(0, spec[1], shape, generator=gen, device=dev)
        keep = torch.arange(shape[0], device=dev) < spec[2]
        return torch.where(keep, ids, 0).to(dtype)
    if kind == "blocks":
        return (torch.arange(shape[0], device=dev) // spec[1]).to(dtype)
    raise ValueError(f"unknown input spec {spec!r}")


def _guitar_args(job: StepJob, params, dev: torch.device, seed: int,
                 m: int) -> tuple:
    """The guitar-serve cell's corpus from N(0, 1) (numpy, ``seed``), each
    shard's graph built on ``dev`` (``build_l2_graph`` at M = ``m``, the
    paper's k_construction 100: NN-descent above 60,000 items), queries
    from N(0, 1)."""
    from repro_torch.graph.build import build_l2_graph
    _, base_t, nbrs_t, _, _, q_t = job.args
    S, Np, D = base_t.shape
    deg = nbrs_t.shape[2]
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((S, Np, D), dtype=np.float32)
    queries = rng.standard_normal(tuple(q_t.shape), dtype=np.float32)
    nbrs = np.full((S, Np, deg), -1, np.int32)
    entries = np.zeros((S,), np.int32)
    for s in range(S):
        g = build_l2_graph(base[s], m=m, k_construction=100, seed=seed + s,
                           device=dev)
        w = min(deg, g.neighbors.shape[1])
        nbrs[s, :, :w] = g.neighbors[:, :w]
        entries[s] = g.entry
    gids = np.arange(S * Np, dtype=np.int32).reshape(S, Np)
    return (params,) + tuple(torch.as_tensor(a, device=dev) for a in
                             (base, nbrs, entries, gids, queries))


def materialize(job: StepJob, device="cuda", seed: int = 0) -> tuple:
    """Real arguments of ``job`` on ``device``: the params through the
    model's own init with a generator on that device seeded ``seed``, every
    other leaf drawn from that generator as ``job.inputs`` says (ids below
    their table, 0/1 masks, the optimizer's moments and step at zero, a
    cache and float inputs from N(0, 1))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = job.init(gen, dev)
    spec = input_spec(job, "1")
    if spec is not None and spec[0] == "graph":
        return _guitar_args(job, params, dev, seed, spec[1])
    rest = job.args[1:]
    leaves = [_draw(input_spec(job, f"{i + 1}/{p}" if p else f"{i + 1}"),
                    leaf, gen, dev)
              for i, arg in enumerate(rest)
              for p, leaf in flatten_with_paths(arg)]
    drawn, k = [], 0
    for arg in rest:
        n = len(flatten_with_paths(arg))
        drawn.append(tree_unflatten(arg, leaves[k:k + n]))
        k += n
    return (params, *drawn)
