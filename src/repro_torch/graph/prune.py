"""Blocked graph-construction kernels in tensor code: occlusion pruning on
the device, and the numpy reverse-edge ``symmetrize``.

``occlusion_prune`` processes nodes in (Nb, kc) blocks with the HNSW
select-neighbors heuristic: candidates ranked by distance to the node,
candidate j kept iff no already-kept candidate occludes it
(``d(c_j, kept) < d(c_j, node)``) and fewer than ``m`` are kept, then a
backfill to degree ``m`` with the nearest non-kept candidates. The
sequential keep-set recurrence advances in chunks of candidates: the
D-dimensional distance work of a chunk (against the compact (Nb, m, D)
kept buffer and within the chunk, in Gram form) is two batched products,
and the strictly sequential part is a short loop of (Nb,)-sized boolean
updates. Same semantics as the JAX package's ``graph/prune.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device

# candidates advanced per recurrence step
_CHUNK = 20


def _prune_block(base: torch.Tensor, node_ids: torch.Tensor,
                 cand: torch.Tensor, m: int,
                 assume_unique: bool = False) -> torch.Tensor:
    """base (N, D) f32; node_ids (Nb,); cand (Nb, kc) int64 -> (Nb, m)
    int32, -1 padded. Distances are squared l2 (only compared)."""
    nb, kc = cand.shape
    D = base.shape[1]
    dev = base.device
    x = base[node_ids]                                    # (Nb, D)
    cvec = base[cand.clamp_min(0)]                        # (Nb, kc, D)
    diff = cvec - x[:, None, :]
    cd2 = torch.sum(diff * diff, dim=-1)                  # (Nb, kc)
    invalid = (cand < 0) | (cand == node_ids[:, None])

    # rank candidates by distance to the node (invalid last), stable
    order = torch.sort(cd2.masked_fill(invalid, float("inf")), dim=1,
                       stable=True).indices
    cd2_s = cd2.gather(1, order)
    ids_s = cand.gather(1, order)
    valid_s = ~invalid.gather(1, order)
    cvec_s = cvec.gather(1, order[..., None].expand(nb, kc, D))

    # duplicate candidate ids: keep only the first (closest) occurrence
    if not assume_unique:
        same = ids_s[:, :, None] == ids_s[:, None, :]
        ar = torch.arange(kc, device=dev)
        earlier = (ar[None, :] < ar[:, None])[None]
        dup = torch.any(same & earlier & valid_s[:, None, :], dim=2)
        valid_s = valid_s & ~dup

    chunk = min(_CHUNK, kc)
    kc_p = -(-kc // chunk) * chunk
    if kc_p != kc:  # pad with never-kept candidates to a whole chunk count
        padc = kc_p - kc
        cvec_s = torch.nn.functional.pad(cvec_s, (0, 0, 0, padc))
        cd2_s = torch.nn.functional.pad(cd2_s, (0, padc))
        valid_s = torch.nn.functional.pad(valid_s, (0, padc))
    rows = torch.arange(nb, device=dev)[:, None]

    kept_vecs = torch.zeros((nb, m, D), dtype=base.dtype, device=dev)
    kept_cnt = torch.zeros((nb, m), dtype=torch.int64, device=dev)
    cnt = torch.zeros((nb,), dtype=torch.int64, device=dev)
    keeps = []
    for c0 in range(0, kc_p, chunk):
        V = cvec_s[:, c0:c0 + chunk]                      # (Nb, c, D)
        cd2_c = cd2_s[:, c0:c0 + chunk]
        valid_c = valid_s[:, c0:c0 + chunk]
        kept_mask = kept_cnt > 0
        vsq = torch.sum(V * V, dim=-1)
        ksq = torch.sum(kept_vecs * kept_vecs, dim=-1)
        dk2 = (vsq[:, :, None] + ksq[:, None, :]
               - 2.0 * torch.einsum("ncd,nmd->ncm", V, kept_vecs))
        occ_buf = torch.any(
            kept_mask[:, None, :] & (dk2 < cd2_c[:, :, None]), dim=2)
        wc2 = (vsq[:, :, None] + vsq[:, None, :]
               - 2.0 * torch.einsum("nad,nbd->nab", V, V))
        occ_in = wc2 < cd2_c[:, :, None]                  # (Nb, c[j], c[l])
        keep = torch.zeros((nb, chunk), dtype=torch.bool, device=dev)
        cnt_run = cnt
        for jj in range(chunk):
            occl = occ_buf[:, jj] | torch.any(keep & occ_in[:, jj], dim=1)
            keep_jj = valid_c[:, jj] & ~occl & (cnt_run < m)
            keep[:, jj] = keep_jj
            cnt_run = cnt_run + keep_jj
        # append kept chunk members: slots are distinct and < m for kept
        # entries; the others add zeros into a clamped slot
        keep_i = keep.long()
        slots = torch.clamp(cnt[:, None] + torch.cumsum(keep_i, dim=1)
                            - keep_i, max=m - 1)
        idx = (rows.expand_as(slots), slots)
        kept_vecs.index_put_(idx, torch.where(keep[..., None], V,
                                              torch.zeros_like(V)),
                             accumulate=True)
        kept_cnt.index_put_(idx, keep_i, accumulate=True)
        cnt = cnt_run
        keeps.append(keep)
    kept = torch.cat(keeps, dim=1)[:, :kc]
    valid_s = valid_s[:, :kc]

    # selection order = kept (by distance) then backfill (by distance),
    # invalid last
    pos = torch.arange(kc, device=dev)[None, :]
    key = torch.where(kept, pos, kc + pos)
    key = torch.where(valid_s, key, 3 * kc + pos)
    sel = torch.sort(key, dim=1, stable=True).indices[:, :min(m, kc)]
    out = ids_s.gather(1, sel)
    out = torch.where(valid_s.gather(1, sel), out, torch.full_like(out, -1))
    if kc < m:
        out = torch.nn.functional.pad(out, (0, m - kc), value=-1)
    return out.int()


def occlusion_prune(base: np.ndarray, knn: np.ndarray, m: int,
                    block: int = 4096, assume_unique: bool = False,
                    device="cuda") -> np.ndarray:
    """Blocked occlusion pruning on ``device``: (N, kc) candidates ->
    (N, m) int32, -1 padded. The block is capped so its (Nb, kc, D)
    candidate gather stays within a few hundred MB."""
    dev = resolve_device(device)
    n, kc = knn.shape
    block = min(block, max(64, int(2e8 / (kc * base.shape[1]))))
    base_t = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    knn_t = torch.as_tensor(np.ascontiguousarray(knn, np.int64), device=dev)
    out = np.empty((n, m), np.int32)
    for s in range(0, n, block):
        e = min(s + block, n)
        ids = torch.arange(s, e, device=dev)
        out[s:e] = _prune_block(base_t, ids, knn_t[s:e], m,
                                assume_unique).cpu().numpy()
    return out


def occlusion_prune_nodes(base: np.ndarray, node_ids: np.ndarray,
                          cand: np.ndarray, m: int,
                          assume_unique: bool = False,
                          device="cuda") -> np.ndarray:
    """Occlusion-prune an arbitrary node set on ``device``: (Nb,) node ids
    + (Nb, kc) candidate ids -> (Nb, m) int32, -1 padded (the streaming
    insert's repair of the touched neighborhood, ``graph/mutate.py``).
    Self-candidates and -1 padding are masked; each row equals the same
    row of a full ``occlusion_prune`` pass. Rows are independent, so the
    set runs in blocks capped as ``occlusion_prune``'s."""
    dev = resolve_device(device)
    node_ids = np.asarray(node_ids, np.int64)
    cand = np.ascontiguousarray(cand, np.int64)
    nb, kc = cand.shape
    out = np.empty((nb, m), np.int32)
    if nb == 0:
        return out
    block = max(64, int(2e8 / (max(kc, 1) * base.shape[1])))
    base_t = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    for s in range(0, nb, block):
        e = min(s + block, nb)
        out[s:e] = _prune_block(
            base_t, torch.as_tensor(node_ids[s:e], device=dev),
            torch.as_tensor(cand[s:e], device=dev), m,
            assume_unique).cpu().numpy()
    return out


def symmetrize(neighbors: np.ndarray, m_max: int) -> np.ndarray:
    """Add reverse edges up to ``m_max`` per node — counting-sort form
    (numpy; the same as the JAX package's ``graph/prune.py``)."""
    n, m = neighbors.shape
    out = np.full((n, m_max), -1, np.int32)
    # compact each row's valid entries into its prefix
    packed = np.argsort(neighbors < 0, axis=1, kind="stable")
    fwd = np.take_along_axis(neighbors, packed, axis=1)
    keep_m = min(m, m_max)
    out[:, :keep_m] = fwd[:, :keep_m]
    deg = np.minimum((neighbors >= 0).sum(1), m_max).astype(np.int64)

    src = np.repeat(np.arange(n, dtype=np.int32), m)
    dst = neighbors.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    # drop reverse edges whose source is already a forward neighbor of dst,
    # and repeated (src, dst) pairs; the membership gather is chunked over
    # the edge list
    present = np.empty(dst.size, bool)
    estep = max(1, 4_000_000 // max(m, 1))
    for s0 in range(0, dst.size, estep):
        e0 = min(s0 + estep, dst.size)
        present[s0:e0] = (neighbors[dst[s0:e0]]
                          == src[s0:e0, None]).any(axis=1)
    src, dst = src[~present], dst[~present]
    _, first = np.unique(src.astype(np.int64) * n + dst, return_index=True)
    first = np.sort(first)
    src, dst = src[first], dst[first]
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(dst, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = deg[dst] + (np.arange(dst.size) - offsets[dst])
    fits = slot < m_max
    out[dst[fits], slot[fits]] = src[fits]
    return out
