"""Streaming index mutation of the port (the JAX package's
``graph/mutate.py``): insert, delete and compact a ``GraphIndex`` without
a rebuild, under a write-ahead journal that makes every mutation
recoverable.

- ``insert_rows``: append rows and repair the graph incrementally. The
  new rows get occlusion-pruned edges from their exact nearest neighbors
  over the grown corpus (``brute_force_knn`` on the device), and only the
  touched nodes (those that gained a reverse edge) re-run the keep-set
  recurrence (``prune.occlusion_prune_nodes``) over their current list
  plus the incoming ids. Cost scales with the rows inserted times the
  degree, not with N.
- ``delete_rows``: tombstone rows in an (N,) bool bitmap. Nothing is
  rewritten: dead rows stay traversable, the engine scores them -inf, and
  a dead entry point moves to the nearest live row.
- ``compact``: rewrite the index without its dead rows (neighbor lists
  remapped, edges into dead rows dropped, tombstones cleared).

Every mutation can append to a ``MutationJournal``: JSON Lines, a
``{"n_base": N}`` header, then one op per line with its whole payload
(insert rows included; float32 round-trips exactly through JSON).
``append_journal`` fsyncs each op line, the commit point of a mutation;
``save_index`` is atomic with ``meta.json`` as its commit point and
records ``journal_applied``, the ops its arrays absorb. ``recover_index``
loads the last durable index and replays the journal's tail through
``apply_op``; every primitive is deterministic, so recovery reproduces
the uninterrupted index exactly. ``DurableIndex`` packages the discipline
and calls ``kill_hook(stage)`` at ``pre-journal``, ``post-journal``,
``pre-save`` and ``post-save`` (``serving.faults.FaultPlan.kill_hook``).
The journal format is the JAX package's: a journal either package writes
loads and replays in the other.

The device work (the kNN and the prune) runs on ``device``, the card
unless the caller says otherwise; on the CPU the results equal the JAX
package's exactly.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import DEFAULT_DEVICE
from repro_torch.graph.build import GraphIndex, brute_force_knn
from repro_torch.graph.prune import occlusion_prune_nodes
from repro_torch.obs.trace import NULL_TRACER

_JOURNAL = "journal.json"


@dataclasses.dataclass
class MutationJournal:
    """Append-only mutation log of one index lineage: ``n_base`` rows in
    the index first built, then the ordered ops (JSON dicts)."""
    n_base: int
    ops: List[dict] = dataclasses.field(default_factory=list)

    def record(self, op: str, **fields) -> None:
        self.ops.append({"op": op, **fields})

    @property
    def n_inserted(self) -> int:
        return sum(o.get("n", 0) for o in self.ops if o["op"] == "insert")

    @property
    def n_deleted(self) -> int:
        return sum(len(o.get("ids", ())) for o in self.ops
                   if o["op"] == "delete")


def save_journal(path: str, journal: MutationJournal) -> str:
    """Write the whole journal as ``journal.json`` in an index directory
    (the header line, then one op per line), atomically (temp, fsync,
    replace). Incremental commits go through ``append_journal``."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, _JOURNAL)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps({"n_base": journal.n_base}) + "\n")
        for op in journal.ops:
            f.write(json.dumps(op) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)
    return out


def append_journal(path: str, op: dict) -> str:
    """Append ONE op line to an existing journal, flushed and fsynced: the
    commit point of a mutation."""
    p = os.path.join(path, _JOURNAL)
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"no journal at {p}; write the header first (save_journal)")
    with open(p, "a") as f:
        f.write(json.dumps(op) + "\n")
        f.flush()
        os.fsync(f.fileno())
    return p


def load_journal(path: str) -> Optional[MutationJournal]:
    """The index directory's journal, or None when it was never mutated
    (no file) or the file has no readable header. A torn or garbage tail
    truncates to the last valid record with a ``RuntimeWarning`` (and
    everything after the first unparsable line is dropped); the older
    whole-file format (``{"n_base": ..., "ops": [...]}``) still loads."""
    p = os.path.join(path, _JOURNAL)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        text = f.read()
    try:            # the whole-file JSON format
        raw = json.loads(text)
        if isinstance(raw, dict) and "ops" in raw:
            return MutationJournal(n_base=int(raw["n_base"]),
                                   ops=list(raw["ops"]))
    except ValueError:
        pass
    records: List[dict] = []
    lines = [ln for ln in text.split("\n") if ln.strip()]
    dropped = 0
    for i, ln in enumerate(lines):
        try:
            rec = json.loads(ln)
            if not isinstance(rec, dict):
                raise ValueError("journal records are objects")
            records.append(rec)
        except ValueError:
            dropped = len(lines) - i
            break
    if dropped:
        warnings.warn(
            f"journal at {p!r} has {dropped} torn/garbage trailing "
            f"record(s); truncating to the last valid record",
            RuntimeWarning)
    if not records or "n_base" not in records[0]:
        warnings.warn(
            f"journal at {p!r} has no readable header; treating the index "
            f"as unmutated", RuntimeWarning)
        return None
    return MutationJournal(n_base=int(records[0]["n_base"]),
                           ops=records[1:])


def _pack_rows(rows: np.ndarray, width: int) -> np.ndarray:
    """Each row's valid (>= 0) entries compacted into its prefix, clipped
    to ``width`` columns."""
    packed = np.argsort(rows < 0, axis=1, kind="stable")
    return np.take_along_axis(rows, packed, axis=1)[:, :width]


def _touched_candidates(neighbors: np.ndarray, touched: np.ndarray,
                        src: np.ndarray, dst: np.ndarray,
                        m: int) -> np.ndarray:
    """Each touched node's candidate row: its current list, then the new
    ids that selected it in edge order (the JAX loop's fill order, by a
    stable sort on the destination)."""
    order = np.argsort(dst, kind="stable")
    d, s = dst[order], src[order]
    row = np.searchsorted(touched, d)
    first = np.searchsorted(d, touched)
    within = np.arange(d.size) - first[row]
    kc_t = m + int(within.max()) + 1
    cand = np.full((touched.size, kc_t), -1, np.int32)
    cand[:, :m] = neighbors[touched]
    cand[row, m + within] = s
    return cand


def insert_rows(index: GraphIndex, new_rows: np.ndarray,
                k_candidates: int = 64,
                journal: Optional[MutationJournal] = None,
                device=DEFAULT_DEVICE) -> GraphIndex:
    """Append ``new_rows`` (K, D) and repair the graph incrementally;
    returns a NEW GraphIndex whose new rows hold ids [N, N+K). (1) Each
    new row's edges: occlusion-pruned from its ``k_candidates`` exact
    nearest neighbors over the grown corpus (never a tombstoned row);
    (2) each node a new row selected gains the reverse edge, and only
    those nodes re-prune, over their list plus the incoming ids."""
    new_rows = np.asarray(new_rows, np.float32)
    if new_rows.ndim != 2 or new_rows.shape[1] != index.base.shape[1]:
        raise ValueError(
            f"new_rows must be (K, {index.base.shape[1]}), got "
            f"{new_rows.shape}")
    K = new_rows.shape[0]
    N0 = index.n
    m = index.max_degree
    base2 = np.concatenate([np.asarray(index.base, np.float32), new_rows])
    new_ids = np.arange(N0, N0 + K, dtype=np.int32)

    # (1) out-edges of the new rows (self-candidates masked in the prune)
    kc = min(k_candidates, N0 + K)
    cand = brute_force_knn(base2, kc, queries=new_rows, device=device)
    if index.tombstones is not None:
        # fresh edges route to live regions
        dead = np.concatenate([np.asarray(index.tombstones, bool),
                               np.zeros(K, bool)])
        cand = np.where(dead[np.maximum(cand, 0)], -1, cand)
    new_nbrs = occlusion_prune_nodes(base2, new_ids, cand, m,
                                     assume_unique=True, device=device)
    neighbors2 = np.concatenate(
        [np.asarray(index.neighbors, np.int32), new_nbrs])

    # (2) reverse edges, and the repair of the touched neighborhood
    src = np.repeat(new_ids, m)
    dst = new_nbrs.reshape(-1)
    ok = dst >= 0
    src, dst = src[ok], dst[ok]
    touched = np.unique(dst)
    if touched.size:
        cand_t = _touched_candidates(neighbors2, touched, src, dst, m)
        neighbors2[touched] = occlusion_prune_nodes(base2, touched, cand_t,
                                                    m, device=device)

    tombstones2 = None
    if index.tombstones is not None:
        tombstones2 = np.concatenate(
            [np.asarray(index.tombstones, bool), np.zeros(K, bool)])
    if journal is not None:
        journal.record("insert", n=int(K), k_candidates=int(k_candidates),
                       rows=new_rows.tolist())
    return GraphIndex(neighbors=neighbors2, entry=index.entry, base=base2,
                      tombstones=tombstones2)


def delete_rows(index: GraphIndex, ids: Sequence[int],
                journal: Optional[MutationJournal] = None) -> GraphIndex:
    """Tombstone rows by id; returns a NEW GraphIndex. A dead entry point
    moves to the nearest live row (squared l2 on the host, as JAX)."""
    ids = np.asarray(list(ids), np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= index.n):
        raise ValueError(f"delete ids must be in [0, {index.n})")
    flags = (np.zeros(index.n, bool) if index.tombstones is None
             else np.asarray(index.tombstones, bool).copy())
    flags[ids] = True
    if flags.all():
        raise ValueError("cannot tombstone every row in the index")
    entry = int(index.entry)
    if flags[entry]:
        alive = np.flatnonzero(~flags)
        d2 = ((index.base[alive] - index.base[entry]) ** 2).sum(axis=1)
        entry = int(alive[np.argmin(d2)])
    if journal is not None:
        journal.record("delete", ids=[int(i) for i in ids])
    return GraphIndex(neighbors=index.neighbors, entry=entry,
                      base=index.base, tombstones=flags)


def compact(index: GraphIndex,
            journal: Optional[MutationJournal] = None) -> GraphIndex:
    """Rewrite the index without its tombstoned rows: live rows repack
    densely, lists remap old -> new ids (edges into dead rows drop, the
    survivors pack to the row's prefix), the entry follows, tombstones
    clear. Returns the index unchanged when nothing is deleted."""
    if index.tombstones is None or not np.asarray(index.tombstones).any():
        if journal is not None:
            journal.record("compact", n_dropped=0)
        return index
    flags = np.asarray(index.tombstones, bool)
    alive = np.flatnonzero(~flags)
    remap = np.full(index.n, -1, np.int64)
    remap[alive] = np.arange(alive.size)
    nbrs = np.asarray(index.neighbors, np.int32)[alive]
    nbrs = np.where(nbrs >= 0, remap[np.maximum(nbrs, 0)], -1)
    nbrs = _pack_rows(nbrs.astype(np.int32), index.max_degree)
    entry = int(remap[int(index.entry)])
    if journal is not None:
        journal.record("compact", n_dropped=int(flags.sum()))
    return GraphIndex(neighbors=nbrs, entry=entry,
                      base=np.asarray(index.base, np.float32)[alive],
                      tombstones=None)


# ---------------------------------------------------------------------------
# crash-safe recovery
# ---------------------------------------------------------------------------

def apply_op(index: GraphIndex, op: dict,
             device=DEFAULT_DEVICE) -> GraphIndex:
    """Replay one journal op (nothing is re-recorded)."""
    kind = op.get("op")
    if kind == "insert":
        if "rows" not in op:
            raise ValueError(
                "journal insert op has no row payload (written before "
                "payload recording); it cannot be replayed — recover from "
                "an index checkpoint that already absorbs it")
        rows = np.asarray(op["rows"], np.float32)
        return insert_rows(index, rows,
                           k_candidates=int(op.get("k_candidates", 64)),
                           device=device)
    if kind == "delete":
        return delete_rows(index, op["ids"])
    if kind == "compact":
        return compact(index)
    raise ValueError(f"unknown journal op {kind!r}")


def recover_index(path: str, device=DEFAULT_DEVICE
                  ) -> Tuple[GraphIndex, MutationJournal]:
    """Load the last durable index and replay the journal ops its arrays
    have not absorbed: ``meta['journal_applied']`` is the watermark (a
    directory without it counts every op as absorbed)."""
    from repro_torch.graph.io import load_index, load_index_meta

    meta = load_index_meta(path)
    index = load_index(path)
    if not isinstance(index, GraphIndex):
        raise ValueError(
            f"recover_index supports graph-kind indexes, got "
            f"{meta.get('kind')!r}")
    journal = load_journal(path)
    if journal is None:
        return index, MutationJournal(n_base=int(meta.get("n", index.n)))
    applied = int(meta.get("journal_applied", len(journal.ops)))
    for op in journal.ops[applied:]:
        index = apply_op(index, op, device=device)
    return index, journal


class DurableIndex:
    """Crash-safe mutation of one index directory. Each mutation
    applies in memory, then its op line lands in the journal
    (``append_journal``, the commit point); ``checkpoint()`` re-saves the
    whole index with ``journal_applied = len(ops)``. A process death
    anywhere loses at most the op whose line never landed; ``open()``
    rebuilds the exact uninterrupted state from what is durable.
    ``kill_hook(stage)`` is called at each of the four stages
    (``serving.faults.MUTATION_STAGES``); traced,
    ``commit`` (apply + journal), ``journal`` and ``checkpoint`` spans go
    out at site ``mutate``."""

    def __init__(self, path: str, index: GraphIndex,
                 journal: MutationJournal, corpus_dtype: str = "float32",
                 page_rows: int = 4096,
                 kill_hook: Optional[Callable[[str], None]] = None,
                 extra_meta: Optional[dict] = None, tracer=None,
                 device=DEFAULT_DEVICE):
        self.path = path
        self.index = index
        self.journal = journal
        self.corpus_dtype = corpus_dtype
        self.page_rows = page_rows
        self.kill_hook = kill_hook
        self.extra_meta = dict(extra_meta or {})
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.device = device

    @classmethod
    def create(cls, path: str, index: GraphIndex,
               corpus_dtype: str = "float32", page_rows: int = 4096,
               kill_hook: Optional[Callable[[str], None]] = None,
               extra_meta: Optional[dict] = None,
               device=DEFAULT_DEVICE) -> "DurableIndex":
        """Start a lineage: checkpoint the index with an empty journal."""
        self = cls(path, index, MutationJournal(n_base=int(index.n)),
                   corpus_dtype, page_rows, kill_hook, extra_meta,
                   device=device)
        self.checkpoint()
        return self

    @classmethod
    def open(cls, path: str,
             kill_hook: Optional[Callable[[str], None]] = None,
             device=DEFAULT_DEVICE) -> "DurableIndex":
        """Recover a lineage from disk (replays the journal's tail in
        memory; ``checkpoint()`` makes the recovered state durable)."""
        from repro_torch.graph.io import load_index_meta

        index, journal = recover_index(path, device=device)
        meta = load_index_meta(path)
        return cls(path, index, journal,
                   corpus_dtype=meta.get("corpus_dtype", "float32"),
                   page_rows=int(meta.get("page_rows", 4096)),
                   kill_hook=kill_hook, device=device)

    def _kill(self, stage: str) -> None:
        if self.kill_hook is not None:
            self.kill_hook(stage)

    def _commit(self, op: dict, apply_fn) -> GraphIndex:
        tr = self.tracer
        t0 = time.perf_counter() if tr.enabled else 0.0
        self._kill("pre-journal")       # dies here: the op is lost
        new_index = apply_fn(self.index)
        tj = time.perf_counter() if tr.enabled else 0.0
        append_journal(self.path, op)   # <- commit point
        if tr.enabled:
            now = time.perf_counter()
            tr.emit("journal", tj, now, site="mutate", op=op["op"])
            tr.emit("commit", t0, now, site="mutate", op=op["op"])
        self._kill("post-journal")      # dies here: the op replays
        self.index = new_index
        self.journal.ops.append(op)
        return self.index

    def insert(self, rows: np.ndarray, k_candidates: int = 64) -> GraphIndex:
        rows = np.asarray(rows, np.float32)
        op = {"op": "insert", "n": int(rows.shape[0]),
              "k_candidates": int(k_candidates), "rows": rows.tolist()}
        return self._commit(
            op, lambda idx: insert_rows(idx, rows,
                                        k_candidates=k_candidates,
                                        device=self.device))

    def delete(self, ids: Sequence[int]) -> GraphIndex:
        op = {"op": "delete", "ids": [int(i) for i in ids]}
        return self._commit(op, lambda idx: delete_rows(idx, op["ids"]))

    def compact(self) -> GraphIndex:
        n_dead = (0 if self.index.tombstones is None
                  else int(np.asarray(self.index.tombstones, bool).sum()))
        op = {"op": "compact", "n_dropped": n_dead}
        return self._commit(op, compact)

    def checkpoint(self) -> str:
        """Persist the current index as the durable baseline: arrays and
        meta (``journal_applied``; meta.json last, the commit point), then
        the journal rewritten clean."""
        from repro_torch.graph.io import save_index

        tr = self.tracer
        t0 = time.perf_counter() if tr.enabled else 0.0
        self._kill("pre-save")          # dies here: the last checkpoint
        save_index(                     # survives, the tail replays
            self.path, self.index, corpus_dtype=self.corpus_dtype,
            extra_meta={**self.extra_meta,
                        "journal_applied": len(self.journal.ops)},
            page_rows=self.page_rows)
        out = save_journal(self.path, self.journal)
        if tr.enabled:
            tr.emit("checkpoint", t0, time.perf_counter(), site="mutate",
                    ops=len(self.journal.ops))
        self._kill("post-save")
        return out
