"""RecSys architectures: DLRM (RM2), DCN-v2, BST, BERT4Rec and their
embedding ops, the counterparts of the JAX package's ``models/recsys.py``
in plain PyTorch over parameter dicts (the JAX models call no kernel, and
neither do these).

The Criteo-style models keep ONE concatenated table with per-field row
offsets (one big gather instead of 26 small ones). Row gathers go through
``layers.gather_rows``, whose backward sums duplicate ids in a fixed
order. Bagged (multi-hot) lookups are a gather plus a segment reduction
(``index_add_``, ``scatter_reduce``); ``kernels.embedding_bag`` is the
kernel of the padded (B, L) form. On one device the JAX models' sharding
constraints are the identity, so the port's forwards take no ``rules``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.models import layers as L

# Criteo Kaggle display-advertising per-field cardinalities (26 sparse fields).
CRITEO_CARDINALITIES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
)


def embedding_lookup(table: torch.Tensor, indices: torch.Tensor
                     ) -> torch.Tensor:
    """Plain row gather: (rows, dim) x (...,) -> (..., dim)."""
    return L.gather_rows(table, indices)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: gather rows, then reduce them into bags.

    indices: (nnz,) rows; segment_ids: (nnz,) bag ids (sorted or not);
    returns (n_bags, dim) in the table's dtype. An empty bag is 0 for
    ``sum`` and ``mean``, and -inf for ``max`` (as ``segment_max``)."""
    rows = embedding_lookup(table, indices)
    if weights is not None:
        rows = rows * weights[:, None].to(rows.dtype)
    seg = segment_ids.long()
    shape = (n_bags, table.shape[1])
    if mode in ("sum", "mean"):
        s = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
        s.index_add_(0, seg, rows)
        if mode == "sum":
            return s
        cnt = torch.zeros((n_bags,), dtype=rows.dtype, device=rows.device)
        cnt.index_add_(0, seg, torch.ones_like(seg, dtype=rows.dtype))
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        out = torch.full(shape, float("-inf"), dtype=rows.dtype,
                         device=rows.device)
        return out.scatter_reduce(0, seg[:, None].expand_as(rows), rows,
                                  reduce="amax", include_self=True)
    raise ValueError(mode)


def field_offsets(cardinalities: Sequence[int]) -> np.ndarray:
    """Row offset of each field in the concatenated table."""
    return np.concatenate([[0], np.cumsum(cardinalities)[:-1]]).astype(
        np.int32)


def multi_field_lookup(table: torch.Tensor, sparse: torch.Tensor,
                       offsets: torch.Tensor) -> torch.Tensor:
    """sparse: (B, F) per-field ids -> (B, F, dim) via one fused gather."""
    return embedding_lookup(table, sparse + offsets[None, :])


def _offsets(cardinalities, device) -> torch.Tensor:
    return torch.as_tensor(field_offsets(cardinalities), device=device)


# ---------------------------------------------------------------------------
# DLRM  [arXiv:1906.00091] — RM2 flavor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    cardinalities: Tuple[int, ...] = CRITEO_CARDINALITIES
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    n_item_fields: int = 13   # trailing fields treated as item-side (retrieval)

    @property
    def n_sparse(self) -> int:
        return len(self.cardinalities)


def dlrm_init(generator: torch.Generator, cfg: DLRMConfig,
              device="cuda") -> dict:
    total_rows = L.pad_vocab(int(sum(cfg.cardinalities)))
    table = L.embed_init(generator, total_rows, cfg.embed_dim, device=device)
    bot = L.init_mlp(generator, [cfg.n_dense, *cfg.bot_mlp], device=device)
    n_vec = cfg.n_sparse + 1
    top_in = n_vec * (n_vec - 1) // 2 + cfg.embed_dim
    top = L.init_mlp(generator, [top_in, *cfg.top_mlp], device=device)
    return {"table": table, "bot": bot, "top": top}


def _dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """vecs: (B, F, d) -> (B, F*(F-1)/2) upper-triangular pairwise dots, in
    the row-major order of ``jnp.triu_indices(F, k=1)``."""
    F_ = vecs.shape[1]
    gram = torch.einsum("bfd,bgd->bfg", vecs, vecs)
    iu, ju = torch.triu_indices(F_, F_, 1, device=vecs.device)
    return gram[:, iu, ju]


def dlrm_forward(params: dict, dense: torch.Tensor, sparse: torch.Tensor,
                 cfg: DLRMConfig) -> torch.Tensor:
    """dense: (B, 13) f32; sparse: (B, 26) ids -> logits (B,)."""
    emb = multi_field_lookup(params["table"], sparse,
                             _offsets(cfg.cardinalities, sparse.device))
    d0 = L.mlp_apply(params["bot"], dense.to(torch.float32))
    vecs = torch.cat([d0[:, None, :], emb], dim=1)             # (B, 27, d)
    top_in = torch.cat([_dot_interaction(vecs), d0], dim=-1)
    return L.mlp_apply(params["top"], top_in)[:, 0]


def dlrm_score_candidates(params: dict, dense: torch.Tensor,
                          user_sparse: torch.Tensor, cand_emb: torch.Tensor,
                          cfg: DLRMConfig) -> torch.Tensor:
    """Retrieval scoring: one user vs N candidates. dense: (13,);
    user_sparse: (n_user_fields,) ids (already offset); cand_emb: (N,
    n_item_fields, d) pre-gathered item-side embeddings."""
    d0 = L.mlp_apply(params["bot"], dense.to(torch.float32))
    user_emb = embedding_lookup(params["table"], user_sparse)   # (Fu, d)
    fixed = torch.cat([d0[None, :], user_emb], dim=0)           # (Fu+1, d)
    N = cand_emb.shape[0]
    vecs = torch.cat([fixed.expand(N, *fixed.shape), cand_emb], dim=1)
    top_in = torch.cat([_dot_interaction(vecs), d0.expand(N, -1)], dim=-1)
    return L.mlp_apply(params["top"], top_in)[:, 0]


# ---------------------------------------------------------------------------
# DCN-v2  [arXiv:2008.13535]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    cardinalities: Tuple[int, ...] = CRITEO_CARDINALITIES
    embed_dim: int = 16
    n_cross_layers: int = 3
    deep_mlp: Tuple[int, ...] = (1024, 1024, 512)
    structure: str = "parallel"   # parallel: cross || deep -> concat -> logit
    n_item_fields: int = 13

    @property
    def n_sparse(self) -> int:
        return len(self.cardinalities)

    @property
    def d_input(self) -> int:
        return self.n_dense + self.n_sparse * self.embed_dim


def dcn_init(generator: torch.Generator, cfg: DCNConfig,
             device="cuda") -> dict:
    total_rows = L.pad_vocab(int(sum(cfg.cardinalities)))
    table = L.embed_init(generator, total_rows, cfg.embed_dim, device=device)
    d = cfg.d_input
    cross = {
        "w": torch.stack([L.dense_init(generator, d, d, device=device)
                          for _ in range(cfg.n_cross_layers)]),
        "b": torch.zeros((cfg.n_cross_layers, d), dtype=torch.float32,
                         device=resolve_device(device)),
    }
    deep = L.init_mlp(generator, [d, *cfg.deep_mlp], device=device)
    head = L.init_mlp(generator, [d + cfg.deep_mlp[-1], 1], device=device)
    return {"table": table, "cross": cross, "deep": deep, "head": head}


def _cross_net(cross: dict, x0: torch.Tensor) -> torch.Tensor:
    """DCN-v2 cross layers: x_{l+1} = x0 * (x_l W_l + b_l) + x_l."""
    x = x0
    for w, b in zip(cross["w"], cross["b"]):
        x = x0 * (x @ w + b) + x
    return x


def dcn_forward(params: dict, dense: torch.Tensor, sparse: torch.Tensor,
                cfg: DCNConfig) -> torch.Tensor:
    emb = multi_field_lookup(params["table"], sparse,
                             _offsets(cfg.cardinalities, sparse.device))
    B = dense.shape[0]
    x0 = torch.cat([dense.to(torch.float32), emb.reshape(B, -1)], dim=-1)
    xc = _cross_net(params["cross"], x0)
    xd = L.mlp_apply(params["deep"], x0)
    return L.mlp_apply(params["head"], torch.cat([xc, xd], dim=-1))[:, 0]


def dcn_score_candidates(params: dict, dense: torch.Tensor,
                         user_sparse: torch.Tensor, cand_emb: torch.Tensor,
                         cfg: DCNConfig) -> torch.Tensor:
    """dense: (13,); user_sparse: (Fu,) offset ids; cand_emb: (N, Fi, d)."""
    user_emb = embedding_lookup(params["table"], user_sparse).reshape(-1)
    fixed = torch.cat([dense.to(torch.float32), user_emb])
    N = cand_emb.shape[0]
    x0 = torch.cat([fixed.expand(N, fixed.shape[0]), cand_emb.reshape(N, -1)],
                   dim=-1)
    xc = _cross_net(params["cross"], x0)
    xd = L.mlp_apply(params["deep"], x0)
    return L.mlp_apply(params["head"], torch.cat([xc, xd], dim=-1))[:, 0]


# ---------------------------------------------------------------------------
# BST — Behavior Sequence Transformer  [arXiv:1905.06874]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 4_000_000
    embed_dim: int = 32
    seq_len: int = 20          # history length (target appended -> seq_len+1)
    n_blocks: int = 1
    n_heads: int = 8
    mlp: Tuple[int, ...] = (1024, 512, 256)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _encoder_block_init(generator: torch.Generator, d: int, d_ff: int,
                        device="cuda") -> dict:
    dev = resolve_device(device)
    p = {k: L.dense_init(generator, a, b, device=dev) for k, a, b in (
        ("wq", d, d), ("wk", d, d), ("wv", d, d), ("wo", d, d),
        ("ffn_up", d, d_ff), ("ffn_down", d_ff, d))}
    for k in ("ln1", "ln2"):
        p[k] = torch.ones((d,), dtype=torch.float32, device=dev)
        p[k + "_b"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return p


def _encoder_block(p: dict, x: torch.Tensor, n_heads: int,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-LN transformer encoder block. x: (B, S, d)."""
    B, S, d = x.shape
    hd = d // n_heads
    q = (x @ p["wq"]).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"]).reshape(B, S, n_heads, hd)
    v = (x @ p["wv"]).reshape(B, S, n_heads, hd)
    attn = L.gqa_attention(q, k, v, mask=mask).reshape(B, S, d) @ p["wo"]
    x = L.layer_norm(x + attn, p["ln1"], p["ln1_b"])
    h = _gelu(x @ p["ffn_up"]) @ p["ffn_down"]
    return L.layer_norm(x + h, p["ln2"], p["ln2_b"])


def bst_init(generator: torch.Generator, cfg: BSTConfig,
             device="cuda") -> dict:
    blocks = [_encoder_block_init(generator, cfg.embed_dim,
                                  4 * cfg.embed_dim, device=device)
              for _ in range(cfg.n_blocks)]
    S = cfg.seq_len + 1
    return {
        "item_table": L.embed_init(generator, L.pad_vocab(cfg.n_items),
                                   cfg.embed_dim, device=device),
        "pos": L.embed_init(generator, S, cfg.embed_dim, device=device),
        "blocks": blocks,
        "mlp": L.init_mlp(generator, [S * cfg.embed_dim, *cfg.mlp, 1],
                          device=device),
    }


def bst_forward(params: dict, hist: torch.Tensor, target: torch.Tensor,
                cfg: BSTConfig) -> torch.Tensor:
    """hist: (B, seq_len) item ids; target: (B,) item id -> logits (B,)."""
    seq = torch.cat([hist, target[:, None]], dim=1)             # (B, S)
    x = embedding_lookup(params["item_table"], seq) + params["pos"][None]
    for blk in params["blocks"]:
        x = _encoder_block(blk, x, cfg.n_heads)
    B = x.shape[0]
    return L.mlp_apply(params["mlp"], x.reshape(B, -1), act=_gelu)[:, 0]


def bst_score_candidates(params: dict, hist: torch.Tensor, cand: torch.Tensor,
                         cfg: BSTConfig) -> torch.Tensor:
    """Cross-encoder retrieval: hist: (seq_len,) one user; cand: (N,) item
    ids. Every candidate re-runs the transformer (a true cross measure)."""
    N = cand.shape[0]
    return bst_forward(params, hist[None, :].expand(N, cfg.seq_len), cand,
                       cfg)


# ---------------------------------------------------------------------------
# BERT4Rec  [arXiv:1904.06690]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BERT4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000   # scaled so retrieval_cand (1e6) is meaningful
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200

    @property
    def vocab(self) -> int:
        return self.n_items + 2  # +PAD, +MASK


def bert4rec_init(generator: torch.Generator, cfg: BERT4RecConfig,
                  device="cuda") -> dict:
    blocks = [_encoder_block_init(generator, cfg.embed_dim,
                                  4 * cfg.embed_dim, device=device)
              for _ in range(cfg.n_blocks)]
    return {
        "item_table": L.embed_init(generator, L.pad_vocab(cfg.vocab),
                                   cfg.embed_dim, device=device),
        "pos": L.embed_init(generator, cfg.seq_len, cfg.embed_dim,
                            device=device),
        "blocks": blocks,
    }


def bert4rec_encode(params: dict, items: torch.Tensor,
                    cfg: BERT4RecConfig) -> torch.Tensor:
    """items: (B, seq_len) -> hidden (B, seq_len, d). Bidirectional; pad
    (id 0) keys masked."""
    x = embedding_lookup(params["item_table"], items) + params["pos"][None]
    pad_mask = (items > 0)[:, None, None, None, :]   # (B,1,1,1,S) keys
    for blk in params["blocks"]:
        x = _encoder_block(blk, x, cfg.n_heads, mask=pad_mask)
    return x


def bert4rec_logits(params: dict, items: torch.Tensor,
                    cfg: BERT4RecConfig) -> torch.Tensor:
    """Masked-item-prediction logits over the item vocab (tied
    embeddings)."""
    h = bert4rec_encode(params, items, cfg)
    return L.mask_pad_vocab(h @ params["item_table"].T, cfg.vocab)


def bert4rec_mlm_loss(params: dict, items: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor,
                      cfg: BERT4RecConfig) -> torch.Tensor:
    logits = bert4rec_logits(params, items, cfg).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    m = mask.to(torch.float32)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def bert4rec_sampled_loss(params: dict, items: torch.Tensor,
                          masked_pos: torch.Tensor, labels: torch.Tensor,
                          negatives: torch.Tensor,
                          cfg: BERT4RecConfig) -> torch.Tensor:
    """Sampled-softmax MLM loss for huge item vocabs. items: (B, S);
    masked_pos: (B, M) positions; labels: (B, M) true items; negatives:
    (N,) shared negative samples."""
    h = bert4rec_encode(params, items, cfg)                       # (B,S,d)
    idx = masked_pos.long()[..., None].expand(-1, -1, h.shape[-1])
    hm = torch.gather(h, 1, idx)                                  # (B,M,d)
    pos_emb = embedding_lookup(params["item_table"], labels)      # (B,M,d)
    neg_emb = embedding_lookup(params["item_table"], negatives)   # (N,d)
    pos_logit = torch.sum(hm * pos_emb, dim=-1, keepdim=True)     # (B,M,1)
    neg_logit = torch.einsum("bmd,nd->bmn", hm, neg_emb)          # (B,M,N)
    logits = torch.cat([pos_logit, neg_logit], dim=-1).to(torch.float32)
    return -torch.mean(torch.log_softmax(logits, dim=-1)[..., 0])


def bert4rec_score_candidates(params: dict, items: torch.Tensor,
                              cand: torch.Tensor,
                              cfg: BERT4RecConfig) -> torch.Tensor:
    """items: (1, seq_len) user history; cand: (N,) item ids -> (N,)
    scores. Two-tower style: encode once, dot with the candidates."""
    h = bert4rec_encode(params, items, cfg)[:, -1, :]             # (1, d)
    cand_emb = embedding_lookup(params["item_table"], cand)       # (N, d)
    return (cand_emb @ h[0]).to(torch.float32)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """mean(max(l, 0) - l y + log1p(exp(-|l|))) over float32 logits
    (``maximum``: its gradient at l = 0 splits as JAX's does)."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
