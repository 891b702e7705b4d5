"""Index files: build once, serve many times. The JAX package's format,
byte for byte in the corpus payloads, so an index written by either
package loads in the other.

An index directory holds:

- ``arrays.npz``: the graph-side arrays (neighbors, shard tables, packed
  tombstones) as compressed npz;
- ``base*.npy``: the v3 corpus payload of a graph index as raw
  ``.npy`` files (``base.npy`` float32 | ``base_bf16.npy`` uint16 bf16
  bit patterns | ``base_q8.npy`` + ``base_scales.npy``), page-aligned by
  ``page_rows`` (recorded in meta with ``n_pages`` and ``page_offsets``);
  a sharded index keeps its payload as npz members;
- ``meta.json``: ``format_version``, ``kind`` (``graph`` | ``sharded``),
  ``corpus_dtype``, scalar fields and provenance (``graph_kind``,
  ``measure_family``).

Every file lands by write-tmp -> flush -> fsync -> rename, ``meta.json``
last (the commit point). Readers take v1 (float32 npz), v2 (quantized npz
payloads) and v3 and refuse newer versions and unknown kinds.

bf16 payloads are written through ``f32_to_bf16_bits`` (the bf16 cast,
round to nearest even: the patterns ``ml_dtypes`` writes) and int8 through
``quantize_rows_int8``; ``load_corpus_store`` hands the saved payload to
``store_from_arrays`` as it is, never widened to float32. Under a
``paged`` policy it returns a ``PagedCorpusStore`` over the payload as
stored: v3 files memory-mapped (``np.load(mmap_mode="r")``), v1 and v2
paged from their npz arrays in host memory.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE
from repro_torch.core.corpus import (CORPUS_DTYPES, AnyCorpusStore,
                                     ResidencyPolicy, as_policy,
                                     f32_to_bf16_bits, make_paged_store,
                                     pack_bitmap, quantize_rows_int8,
                                     store_from_arrays, unpack_bitmap)
from repro_torch.graph.build import GraphIndex

FORMAT_VERSION = 3
_ARRAYS = "arrays.npz"
_META = "meta.json"

# corpus payload keys per residency (npz member names; v3 file = key.npy)
_PAYLOAD_KEYS = {
    "float32": ("base",),
    "bfloat16": ("base_bf16",),
    "int8": ("base_q8", "base_scales"),
}


def _payload_file(key: str) -> str:
    return f"{key}.npy"


def _fsync_dir(path: str) -> None:
    """fsync the directory entry so renames inside it are durable (no-op on
    platforms whose directories refuse O_RDONLY fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - platform-dependent
        pass


def _atomic_write(path: str, write_fn: Callable) -> None:
    """write-tmp -> flush -> fsync -> rename: a crash mid-write never
    leaves a torn file at ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _encode_base(base: np.ndarray, corpus_dtype: str) -> dict:
    """float32 (N|S, ..., D) base -> payload arrays per residency format."""
    if corpus_dtype == "float32":
        return {"base": np.asarray(base, np.float32)}
    if corpus_dtype == "bfloat16":
        bits = f32_to_bf16_bits(torch.from_numpy(
            np.ascontiguousarray(base, np.float32)))
        return {"base_bf16": bits.numpy().view(np.uint16)}
    if corpus_dtype == "int8":
        q8, scales = quantize_rows_int8(torch.from_numpy(
            np.ascontiguousarray(base, np.float32)))
        return {"base_q8": q8.numpy(), "base_scales": scales.numpy()}
    raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}, "
                     f"got {corpus_dtype!r}")


def _decode_base(arrays: dict, corpus_dtype: str) -> np.ndarray:
    """payload arrays -> float32 base (the quantization round-trip
    applied; the bf16 widen and the int8 product are exact in numpy)."""
    if corpus_dtype == "bfloat16":
        bits = np.asarray(arrays["base_bf16"], np.uint16)
        return (bits.astype(np.uint32) << 16).view(np.float32)
    if corpus_dtype == "int8":
        return (np.asarray(arrays["base_q8"]).astype(np.float32)
                * np.asarray(arrays["base_scales"], np.float32))
    return np.asarray(arrays["base"])


def save_index(path: str, index, corpus_dtype: str = "float32",
               extra_meta: Optional[dict] = None,
               page_rows: int = 4096) -> str:
    """Write a GraphIndex or ShardedIndex under directory ``path``, the
    base stored in ``corpus_dtype`` residency; ``page_rows`` sets the v3
    page layout recorded in meta; ``extra_meta``: JSON-serializable
    provenance merged into meta.json. A ``GraphIndex.tombstones`` delete
    bitmap round-trips packed. Returns the path of the meta file."""
    from repro_torch.core.sharded import ShardedIndex  # avoid an import cycle

    if page_rows < 1:
        raise ValueError(f"page_rows must be >= 1, got {page_rows}")
    os.makedirs(path, exist_ok=True)
    payload = {}
    if isinstance(index, GraphIndex):
        kind = "graph"
        arrays = {"neighbors": index.neighbors}
        payload = _encode_base(index.base, corpus_dtype)
        n = int(index.n)
        n_pages = -(-n // page_rows)
        meta = {"entry": int(index.entry), "n": n,
                "dim": int(index.base.shape[1]),
                "max_degree": int(index.max_degree),
                "avg_degree": float(index.avg_degree),
                "page_rows": int(page_rows), "n_pages": n_pages,
                "page_offsets": [int(p * page_rows)
                                 for p in range(n_pages)],
                "payload_files": {k: _payload_file(k) for k in payload}}
        if index.tombstones is not None:
            arrays["tombstones"] = pack_bitmap(np.asarray(index.tombstones))
    elif isinstance(index, ShardedIndex):
        kind = "sharded"
        arrays = {"neighbors": index.neighbors, "entries": index.entries,
                  "global_ids": index.global_ids,
                  **_encode_base(index.base, corpus_dtype)}
        meta = {"n_shards": int(index.n_shards),
                "rows_per_shard": int(index.base.shape[1]),
                "dim": int(index.base.shape[2]),
                "n": int((index.global_ids >= 0).sum())}
    else:
        raise TypeError(f"cannot serialize {type(index).__name__}")

    # every file by write-tmp -> fsync -> rename, meta.json LAST: a crash
    # in between leaves the previous index version readable
    _atomic_write(os.path.join(path, _ARRAYS),
                  lambda f: np.savez_compressed(f, **arrays))
    for key, arr in payload.items():
        _atomic_write(os.path.join(path, _payload_file(key)),
                      lambda f, a=arr: np.save(f, a))
    meta = {"format_version": FORMAT_VERSION, "kind": kind,
            "corpus_dtype": corpus_dtype, **meta, **(extra_meta or {})}
    blob = json.dumps(meta, indent=2, sort_keys=True).encode()
    meta_path = os.path.join(path, _META)
    _atomic_write(meta_path, lambda f: f.write(blob))
    _fsync_dir(path)
    return meta_path


def load_index_meta(path: str) -> dict:
    """The parsed, version-checked meta.json of an index directory
    (construction provenance included)."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    version = meta.get("format_version")
    if not isinstance(version, int) or version < 1 \
            or version > FORMAT_VERSION:
        raise ValueError(
            f"index at {path!r} has format_version={version!r}; this reader "
            f"supports 1..{FORMAT_VERSION}")
    return meta


def _read(path: str, mmap: bool = False) -> Tuple[dict, dict]:
    """meta and every array: the npz members, plus (v3 graph) the
    payload files, memory-mapped read-only when ``mmap``."""
    meta = load_index_meta(path)
    dtype = meta.get("corpus_dtype", "float32")
    if dtype not in CORPUS_DTYPES:
        raise ValueError(f"index at {path!r} has unknown corpus_dtype "
                         f"{dtype!r}")
    with np.load(os.path.join(path, _ARRAYS)) as z:
        arrays = {k: z[k] for k in z.files}
    if meta["format_version"] >= 3 and meta.get("kind") == "graph":
        for k in _PAYLOAD_KEYS[dtype]:
            arrays[k] = np.load(os.path.join(path, _payload_file(k)),
                                mmap_mode="r" if mmap else None)
    return meta, arrays


def _tombstone_flags(meta: dict, arrays: dict) -> Optional[np.ndarray]:
    if "tombstones" not in arrays:
        return None
    return unpack_bitmap(arrays["tombstones"], int(meta["n"]))


def load_index(path: str) -> Union[GraphIndex, "ShardedIndex"]:
    """Load an index directory written by ``save_index`` (either
    package's). The returned index carries a float32 ``base`` (bf16 / int8
    payloads dequantized); ``load_corpus_store`` keeps them quantized."""
    from repro_torch.core.sharded import ShardedIndex  # avoid an import cycle

    meta, arrays = _read(path)
    kind = meta.get("kind")
    if kind not in ("graph", "sharded"):
        raise ValueError(f"index at {path!r} has unknown kind {kind!r}")
    base = _decode_base(arrays, meta.get("corpus_dtype", "float32"))
    if kind == "graph":
        return GraphIndex(neighbors=arrays["neighbors"],
                          entry=int(meta["entry"]), base=base,
                          tombstones=_tombstone_flags(meta, arrays))
    return ShardedIndex(base=base, neighbors=arrays["neighbors"],
                        entries=arrays["entries"],
                        global_ids=arrays["global_ids"],
                        n_shards=int(meta["n_shards"]))


def load_corpus_store(path: str, residency=None,
                      device=DEFAULT_DEVICE) -> AnyCorpusStore:
    """A graph index's base vectors as a corpus store in the dtype they
    were saved in, with any saved tombstones (words on ``device``).

    ``residency`` None / 'whole': a whole-resident ``CorpusStore`` on
    ``device``, the payload handed to ``store_from_arrays`` as stored (bf16
    bit patterns, int8 + scales). A ``paged`` policy (or 'paged'): a
    ``PagedCorpusStore`` whose rows go to ``device``; v3 payloads are
    memory-mapped, so rows enter host memory page fault by page fault and
    the footprint stays bounded by the policy's ``cache_bytes``; v1 and v2
    page from their npz arrays. A policy that keeps the default
    ``page_rows`` takes the page size recorded in the index meta, so pages
    line up with the layout the file was written under."""
    policy = as_policy(residency)
    paged = policy.kind == "paged"
    meta, arrays = _read(path, mmap=paged)
    if meta.get("kind") != "graph":
        raise ValueError(
            f"load_corpus_store supports single-partition graph indexes; "
            f"index at {path!r} has kind {meta.get('kind')!r} (sharded "
            f"residency quantizes per partition: core.sharded.shard_stores)")
    corpus_dtype = meta.get("corpus_dtype", "float32")
    flags = _tombstone_flags(meta, arrays)
    keys = _PAYLOAD_KEYS[corpus_dtype]
    data = arrays[keys[0]]
    scales = arrays[keys[1]] if len(keys) > 1 else None
    if paged:
        if policy.page_rows == ResidencyPolicy().page_rows \
                and "page_rows" in meta:
            policy = dataclasses.replace(policy,
                                         page_rows=int(meta["page_rows"]))
        return make_paged_store(data, corpus_dtype, policy, scales, flags,
                                device=device)
    return store_from_arrays(
        data, scales, corpus_dtype,
        None if flags is None else pack_bitmap(flags), device=device)
