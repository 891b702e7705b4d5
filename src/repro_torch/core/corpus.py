"""Corpus residency for the expansion engine: the (N, D) corpus held on the
device in float32, bfloat16 or per-row-scaled int8, dequantized on gather.

``CorpusStore.take`` is the plain gather + dequant; the index-fused kernels
(``deepfm_score_fused``, ``neighbor_rank_fused``, ``deepfm_grad_fused``)
gather and dequantize the same rows inside the kernel, with the same
rounding, so ``take`` is also their plain version's first step.

Formats (those of the JAX package's ``core/corpus.py``, bit for bit):

- float32: ``data`` (N, D) float32.
- bfloat16: ``data`` (N, D) ``torch.bfloat16``; its bits are the JAX
  store's uint16 patterns, and ``.float()`` is the exact widen.
- int8: ``data`` (N, D) int8 with ``scales`` (N, 1) float32,
  ``q8 = round(x / scale)``, ``scale = max(max|x|, 1e-8) / 127`` per row;
  a row dequantizes as ``float(q8) * scale``, rounded to float32.

A store may carry a tombstone bitmap of deleted rows: packed uint32 words
(one bit per row, the visited bitmap's layout) held in an int64 tensor.
The engine scores tombstoned entries and candidates -inf.

**Residency is a policy** (``ResidencyPolicy``), as in the JAX package:

- ``whole``: the (N, D) payload lives on the device (``CorpusStore``).
- ``paged``: the payload stays in host memory or on disk (``np.load(...,
  mmap_mode="r")`` of index v3's page-aligned files) in fixed ``page_rows``
  row pages, faulted on demand into an LRU page cache bounded by
  ``cache_bytes`` of **host** memory (``PagedCorpusStore``, ``_PageCache``).
  A gather dequantizes on the host with the whole store's arithmetic (the
  bf16 widen and the int8 product are exact IEEE operations), so a paged
  gather equals the whole store's ``take`` bit for bit. The engine gathers
  one (Q, 1+B) block of rows per step through the pager between two
  captured halves of the step (``core/engine.py``): a captured CUDA graph
  cannot call back into the host, where the JAX package's search calls the
  pager inside the step (``jax.pure_callback``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.obs.trace import NULL_TRACER

CORPUS_DTYPES = ("float32", "bfloat16", "int8")
RESIDENCY_KINDS = ("whole", "paged")
_EPS = 1e-8


def _check_dtype(corpus_dtype: str) -> None:
    if corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}, "
                         f"got {corpus_dtype!r}")


@dataclasses.dataclass(frozen=True)
class ResidencyPolicy:
    """How the corpus payload is held during search (the JAX package's
    policy, field for field).

    kind:        'whole' (device-resident (N, D) payload, the default) |
                 'paged' (fixed-size row pages faulted on demand into a
                 host LRU cache bounded by ``cache_bytes``)
    page_rows:   rows per page (paged only)
    cache_bytes: LRU byte budget of the host page copies (paged only)

    Failure policy (paged only): a page read that raises ``OSError`` is
    retried up to ``max_retries`` times with exponential backoff
    (``retry_backoff_s * 2**attempt``); if every retry fails the pager
    degrades: it reads the whole payload once and serves every later
    gather from that host copy (``stats.fallback == 'whole'``), unless the
    payload exceeds ``fallback_bytes`` (None = always allowed), in which
    case ``CorpusUnavailableError`` surfaces and the shard above the store
    is the fault domain that fails.
    """
    kind: str = "whole"
    page_rows: int = 4096
    cache_bytes: int = 64 << 20
    max_retries: int = 3
    retry_backoff_s: float = 0.001
    fallback_bytes: Optional[int] = None

    def __post_init__(self):
        if self.kind not in RESIDENCY_KINDS:
            raise ValueError(f"residency kind must be one of "
                             f"{RESIDENCY_KINDS}, got {self.kind!r}")
        if self.kind == "paged" and self.page_rows < 1:
            raise ValueError(f"page_rows must be >= 1, got {self.page_rows}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")


WHOLE = ResidencyPolicy()


def as_policy(residency) -> ResidencyPolicy:
    """None, a kind name ('whole' | 'paged', with the default knobs) or a
    policy (a ``ResidencyPolicy``, or any object with its fields, such as
    the JAX package's, whose missing fields take the defaults) -> a
    ``ResidencyPolicy``; an unknown kind raises ``ValueError``."""
    if residency is None:
        return WHOLE
    if isinstance(residency, ResidencyPolicy):
        return residency
    if isinstance(residency, str):
        return ResidencyPolicy(kind=residency)
    return ResidencyPolicy(**{
        f.name: getattr(residency, f.name)
        for f in dataclasses.fields(ResidencyPolicy)
        if hasattr(residency, f.name)})


# ---------------------------------------------------------------------------
# bitmaps and quantization
# ---------------------------------------------------------------------------

def pack_bitmap(flags: np.ndarray) -> np.ndarray:
    """(N,) bool -> packed (ceil(N/32),) uint32 words (bit i of word i//32),
    the same layout as the engine's per-lane visited bitmap."""
    flags = np.asarray(flags, bool)
    pad = (-flags.shape[0]) % 32
    if pad:
        flags = np.concatenate([flags, np.zeros(pad, bool)])
    bits = flags.reshape(-1, 32).astype(np.uint32)
    return (bits << np.arange(32, dtype=np.uint32)[None, :]).sum(
        axis=1, dtype=np.uint32)


def unpack_bitmap(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of ``pack_bitmap``: (W,) uint32 -> (n,) bool."""
    words = np.asarray(words, np.uint32)
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:n].astype(bool)


def bit_test_global(words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Packed global bitmap test: words (W,) uint32 values in an int64
    tensor, ids (...,) int -> bool. Negative ids test bit 0 of word 0 and
    ids past the end test the last word (callers mask them)."""
    safe = ids.long().clamp_min(0)
    w = words[(safe >> 5).clamp_max(words.shape[0] - 1)]
    return ((w >> (safe & 31)) & 1).bool()


def quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization over the last axis:
    (..., D) float -> (q8 (..., D) int8, scales (..., 1) float32).
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The
    divisor 127 is a tensor on x's device: on a CUDA tensor PyTorch
    divides by a Python scalar as a product with its reciprocal, which
    leaves some scales an ulp off the JAX package's (and the CPU's)."""
    x = x.float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scales = amax.clamp_min(_EPS) / torch.full_like(amax, 127.0)
    q8 = torch.clamp(torch.round(x / scales), -127, 127).to(torch.int8)
    return q8, scales


def dequantize_rows_int8(q8: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """Inverse of ``quantize_rows_int8`` (up to rounding error)."""
    return q8.float() * scales


def f32_to_bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bf16 bit patterns (round to nearest even, as the bf16
    cast), as int16 holding the uint16 patterns."""
    return x.float().to(torch.bfloat16).view(torch.int16)


def bf16_bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns (int16 or uint16 storage) -> float32: widen,
    shift, bitcast, which is exact."""
    wide = (bits.view(torch.int16).int() & 0xFFFF) << 16
    return wide.view(torch.float32)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

_STORAGE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}


class CorpusStore:
    """Dtype-tagged resident corpus: (N, D) payload, (N, 1) float32 row
    scales for int8 (None otherwise), and optional packed tombstone words
    (an int64 tensor of uint32 values)."""

    is_paged = False

    def __init__(self, data: torch.Tensor, scales: Optional[torch.Tensor],
                 dtype: str, tombstones: Optional[torch.Tensor] = None):
        _check_dtype(dtype)
        if data.dim() != 2 or data.dtype != _STORAGE[dtype]:
            raise ValueError(f"{dtype} corpus must be (N, D) "
                             f"{_STORAGE[dtype]}, got {tuple(data.shape)} "
                             f"{data.dtype}")
        if (dtype == "int8") != (scales is not None):
            raise ValueError("int8 residency needs (N, 1) scales, and only "
                             "int8 has them")
        if scales is not None and (scales.dtype != torch.float32 or tuple(
                scales.shape) != (data.shape[0], 1)):
            raise ValueError(f"scales must be ({data.shape[0]}, 1) float32, "
                             f"got {tuple(scales.shape)} {scales.dtype}")
        if tombstones is not None and tuple(tombstones.shape) != (
                (data.shape[0] + 31) // 32,):
            raise ValueError(f"tombstones must be ((N+31)//32,) words, got "
                             f"{tuple(tombstones.shape)}")
        self.data = data.contiguous()
        self.scales = None if scales is None else scales.contiguous()
        self.dtype = dtype
        self.tombstones = tombstones

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    def take(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows by id (any ids shape) -> (..., D) float32."""
        rows = self.data[ids]
        if self.dtype == "int8":
            return rows.float() * self.scales[ids]
        return rows.float()

    def take_raw(self, ids: torch.Tensor) -> torch.Tensor:
        """Gather rows in residency format (no dequant)."""
        return self.data[ids]

    def dequantize(self) -> torch.Tensor:
        """The full (N, D) float32 corpus (materializes it for bf16/int8)."""
        if self.dtype == "int8":
            return dequantize_rows_int8(self.data, self.scales)
        return self.data.float()

    def nbytes(self) -> int:
        """Resident payload bytes (data + scales)."""
        total = self.data.numel() * self.data.element_size()
        if self.scales is not None:
            total += self.scales.numel() * self.scales.element_size()
        return int(total)

    def with_tombstones(self, flags: Optional[np.ndarray]) -> "CorpusStore":
        """A view of this store with the (N,) bool delete flags packed into
        the tombstone bitmap (None clears it)."""
        words = None if flags is None else _words_tensor(pack_bitmap(flags),
                                                         self.device)
        return CorpusStore(self.data, self.scales, self.dtype, words)

    def __repr__(self) -> str:
        return (f"CorpusStore(n={self.n}, dim={self.dim}, dtype={self.dtype}"
                f", device={self.device})")


def _quantize(base: torch.Tensor, corpus_dtype: str):
    if corpus_dtype == "bfloat16":
        return base.to(torch.bfloat16), None
    if corpus_dtype == "int8":
        return quantize_rows_int8(base)
    return base, None


def _words_tensor(words: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(words, np.uint32).astype(np.int64),
                           device=device)



# ---------------------------------------------------------------------------
# paged residency
# ---------------------------------------------------------------------------

class CorpusUnavailableError(RuntimeError):
    """The pager exhausted its retries AND could not degrade to its whole
    host copy: the corpus behind this store is offline. The sharded
    runtime strikes the shard above the store (``SHARD_FAULTS``)."""


@dataclasses.dataclass
class PageCacheStats:
    """Host-side pager accounting (the JAX package's fields)."""
    hits: int = 0
    faults: int = 0
    evictions: int = 0
    resident_bytes: int = 0
    peak_resident_bytes: int = 0
    retries: int = 0         # physical reads re-attempted after OSError
    io_errors: int = 0       # OSErrors observed (pre-retry, pre-fallback)
    fallback: str = ""       # "" = paged; "whole" = degraded to resident

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.faults
        return self.hits / total if total else 0.0


# the host payload's numpy dtype per residency (bf16 as uint16 patterns)
_HOST_DTYPES = {"float32": np.float32, "bfloat16": np.uint16,
                "int8": np.int8}


def _host_dequantize(rows: np.ndarray, scales: Optional[np.ndarray],
                    dtype: str) -> np.ndarray:
    """numpy twins of ``CorpusStore.take``'s dequant: the bf16 widen and
    the int8 product are exact IEEE operations, so the rows equal the
    device store's bit for bit."""
    if dtype == "bfloat16":
        return (rows.astype(np.uint32) << 16).view(np.float32)
    if dtype == "int8":
        return rows.astype(np.float32) * scales
    return rows.astype(np.float32)


class _PageCache:
    """Host pager: ``page_rows`` row pages over a payload array (an
    ``np.memmap`` of io v3's page-aligned files, or a host ndarray),
    faulted on demand and held under an LRU byte budget. The pages a gather
    needs are pinned for it: the budget evicts cold pages, never the
    working set, so one gather larger than the budget still completes
    (``peak_resident_bytes`` records the overshoot).

    Behavior, counts and read-hook calls are the JAX pager's on the same
    trace of gathers; the bookkeeping is vectorised over pages. Resident
    pages live in slots of one host slab (so a gather is one fancy index,
    not a loop over pages), the LRU order is a last-use stamp per page (a
    gather touches its pages in ascending page order, as the JAX pager's
    ``OrderedDict`` does), and only page faults run a Python loop, in
    ascending page order, counting the hits before each fault first: a
    fault that degrades or gives up mid-gather leaves the counters where
    the JAX pager leaves them. Without a read hook or a tracer, which need
    a call per page, a gather faults its missing pages in one vectorised
    read (``_fault_batch``) with the same accounting."""

    def __init__(self, data: np.ndarray, scales: Optional[np.ndarray],
                 dtype: str, policy: ResidencyPolicy):
        _check_dtype(dtype)
        if data.ndim != 2 or data.dtype != _HOST_DTYPES[dtype]:
            raise ValueError(f"a {dtype} page payload must be (N, D) "
                             f"{np.dtype(_HOST_DTYPES[dtype])}, got "
                             f"{data.shape} {data.dtype}")
        if (dtype == "int8") != (scales is not None):
            raise ValueError("int8 paged residency requires per-row scales, "
                             "and only int8 has them")
        self.data = data
        self.scales = scales
        self.dtype = dtype
        self.policy = policy
        self.n, self.dim = data.shape
        self.page_rows = int(policy.page_rows)
        self.n_pages = -(-self.n // self.page_rows)
        row_bytes = self.dim * data.dtype.itemsize
        if scales is not None:
            row_bytes += int(np.prod(scales.shape[1:])) \
                * scales.dtype.itemsize
        rows = np.full(self.n_pages, self.page_rows, np.int64)
        rows[-1] = self.n - (self.n_pages - 1) * self.page_rows
        self._page_bytes = rows * row_bytes
        self._slot = np.full(self.n_pages, -1, np.int64)
        self._stamp = np.zeros(self.n_pages, np.int64)
        self._clock = 0
        self._new_slab(0)
        self.stats = PageCacheStats()
        # fault-injection surface: read_hook(pid, attempt) before every
        # physical read (pid == -1 for the whole-payload fallback read); an
        # OSError it raises is a real I/O failure to the pager
        self.read_hook: Optional[Callable[[int, int], None]] = None
        self._whole: Optional[np.ndarray] = None
        self._whole_scales: Optional[np.ndarray] = None
        # page_fault / fallback spans, site "pager", no rid (a fault serves
        # every lane of its step)
        self.tracer = NULL_TRACER

    def _new_slab(self, cap: int) -> None:
        rows = min(self.page_rows, self.n)
        self._slab = np.empty((cap, rows, self.dim), self.data.dtype)
        self._slab_scales = None if self.scales is None else np.empty(
            (cap, rows) + self.scales.shape[1:], self.scales.dtype)
        self._free = list(range(cap - 1, -1, -1))

    def _alloc_slots(self, k: int) -> np.ndarray:
        """k free slab slots, the slab grown (doubling) when short."""
        short = k - len(self._free)
        if short > 0:
            cap = self._slab.shape[0]
            old, old_s, free = self._slab, self._slab_scales, self._free
            self._new_slab(max(16, 2 * cap, cap + short))
            self._slab[:cap] = old
            if old_s is not None:
                self._slab_scales[:cap] = old_s
            self._free = list(range(self._slab.shape[0] - 1, cap - 1,
                                    -1)) + free
        out = self._free[len(self._free) - k:][::-1]
        del self._free[len(self._free) - k:]
        return np.asarray(out, np.int64)

    def _read_block(self, lo: int, hi: int, pid: int) -> tuple:
        """One physical read with bounded exponential-backoff retries: the
        first rung of the degradation ladder."""
        last: Optional[OSError] = None
        for attempt in range(self.policy.max_retries + 1):
            if attempt:
                self.stats.retries += 1
                if self.policy.retry_backoff_s > 0:
                    time.sleep(self.policy.retry_backoff_s
                               * (1 << (attempt - 1)))
            try:
                if self.read_hook is not None:
                    self.read_hook(pid, attempt)
                payload = np.array(self.data[lo:hi])    # copy off the mmap
                scales = None if self.scales is None \
                    else np.array(self.scales[lo:hi])
                return payload, scales
            except OSError as err:
                self.stats.io_errors += 1
                last = err
        raise last

    def payload_nbytes(self) -> int:
        nbytes = self.data.size * self.data.dtype.itemsize
        if self.scales is not None:
            nbytes += self.scales.size * self.scales.dtype.itemsize
        return int(nbytes)

    def _fallback_whole(self, cause: OSError) -> None:
        """Retries exhausted on a page: degrade to one whole host copy of
        the payload or, past ``fallback_bytes``, give up with
        ``CorpusUnavailableError``."""
        nbytes = self.payload_nbytes()
        limit = self.policy.fallback_bytes
        if limit is not None and nbytes > limit:
            raise CorpusUnavailableError(
                f"page read failed after {self.policy.max_retries} retries "
                f"and the whole payload ({nbytes}B) exceeds "
                f"fallback_bytes={limit}") from cause
        tr = self.tracer
        t0 = time.perf_counter() if tr.enabled else 0.0
        try:
            self._whole, self._whole_scales = self._read_block(0, self.n, -1)
        except OSError as err:
            if tr.enabled:
                tr.emit("fallback", t0, time.perf_counter(), site="pager",
                        rows=self.n, failed=True)
            raise CorpusUnavailableError(
                f"page read failed after {self.policy.max_retries} retries "
                f"and the whole-payload fallback read failed too") from err
        if tr.enabled:
            tr.emit("fallback", t0, time.perf_counter(), site="pager",
                    rows=self.n)
        self.stats.fallback = "whole"
        self._slot[:] = -1                  # page copies are redundant now
        self._new_slab(0)
        self.stats.resident_bytes = nbytes
        self.stats.peak_resident_bytes = max(self.stats.peak_resident_bytes,
                                             nbytes)

    def _fault(self, pid: int) -> None:
        s, e = pid * self.page_rows, min((pid + 1) * self.page_rows, self.n)
        tr = self.tracer
        t0 = time.perf_counter() if tr.enabled else 0.0
        errs0 = self.stats.io_errors
        try:
            payload, scales = self._read_block(s, e, pid)
        except OSError as err:
            if tr.enabled:
                tr.emit("page_fault", t0, time.perf_counter(), site="pager",
                        pid=int(pid), failed=True,
                        io_errors=self.stats.io_errors - errs0)
            self._fallback_whole(err)
            return
        if tr.enabled:
            kw = {"pid": int(pid), "rows": int(e - s)}
            n_err = self.stats.io_errors - errs0
            if n_err:            # retry-absorbed errors, visible in traces
                kw["io_errors"] = n_err
            tr.emit("page_fault", t0, time.perf_counter(), site="pager",
                    **kw)
        slot = int(self._alloc_slots(1)[0])
        self._slab[slot, :e - s] = payload
        if scales is not None:
            self._slab_scales[slot, :e - s] = scales
        self._slot[pid] = slot
        self.stats.faults += 1
        self.stats.resident_bytes += int(self._page_bytes[pid])
        self.stats.peak_resident_bytes = max(self.stats.peak_resident_bytes,
                                             self.stats.resident_bytes)

    def _fault_batch(self, pids: np.ndarray) -> None:
        """Fault ``pids`` (ascending) with one vectorised read: the loop's
        accounting, without its per-page Python work. Used when no read
        hook or tracer needs a call per page; a read that raises
        ``OSError`` leaves nothing changed, and the caller retries the
        pages one by one through ``_fault``."""
        rows = self._slab.shape[1]
        idx = np.minimum(pids[:, None] * self.page_rows
                         + np.arange(rows)[None, :], self.n - 1).reshape(-1)
        payload = np.asarray(self.data[idx]).reshape(
            (pids.size, rows) + self.data.shape[1:])
        scales = None if self.scales is None else np.asarray(
            self.scales[idx]).reshape((pids.size, rows)
                                      + self.scales.shape[1:])
        slots = self._alloc_slots(pids.size)
        self._slab[slots] = payload
        if scales is not None:
            self._slab_scales[slots] = scales
        self._slot[pids] = slots
        self.stats.faults += int(pids.size)
        self.stats.resident_bytes += int(self._page_bytes[pids].sum())
        self.stats.peak_resident_bytes = max(self.stats.peak_resident_bytes,
                                             self.stats.resident_bytes)

    def _evict_cold(self, need: np.ndarray) -> None:
        """Evict least recently used pages outside ``need`` until the
        footprint is within budget (or only pinned pages are left)."""
        excess = self.stats.resident_bytes - self.policy.cache_bytes
        if excess <= 0:
            return
        pinned = np.zeros(self.n_pages, bool)
        pinned[need] = True
        cold = np.flatnonzero((self._slot >= 0) & ~pinned)
        if cold.size == 0:
            return                                  # working set > budget
        cold = cold[np.argsort(self._stamp[cold], kind="stable")]
        freed = np.cumsum(self._page_bytes[cold])
        k = min(int(np.searchsorted(freed, excess)) + 1, cold.size)
        victims = cold[:k]
        self._free.extend(self._slot[victims].tolist())
        self._slot[victims] = -1
        self.stats.evictions += k
        self.stats.resident_bytes -= int(freed[k - 1])

    def gather(self, ids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """ids (any shape) -> (..., D) float32 dequantized rows, written
        into ``out`` when given (an (..., D) float32 array, such as a
        pinned host tile); out-of-range ids clamp (the JAX store's clip
        contract)."""
        ids = np.asarray(ids)
        shape = ids.shape
        flat = np.clip(ids.astype(np.int64).reshape(-1), 0, self.n - 1)
        if self._whole is None:
            pids = flat // self.page_rows
            need = np.unique(pids)
            resident = self._slot[need] >= 0
            miss = np.flatnonzero(~resident)
            hits0 = self.stats.hits
            hits_before = np.cumsum(resident) - resident
            batched = False
            if miss.size and self.read_hook is None \
                    and not self.tracer.enabled:
                try:
                    self._fault_batch(need[miss])
                    batched = True
                except OSError:
                    pass
            for i in ([] if batched else miss.tolist()):
                self.stats.hits = hits0 + int(hits_before[i])
                self._fault(int(need[i]))
                if self._whole is not None:
                    break                   # degraded mid-gather
            else:
                self.stats.hits = hits0 + int(np.count_nonzero(resident))
                self._stamp[need] = self._clock + np.arange(need.size)
                self._clock += need.size
        if self._whole is not None:
            # degraded to the whole host copy: same dequant, same rows
            rows = _host_dequantize(
                self._whole[flat], None if self._whole_scales is None
                else self._whole_scales[flat], self.dtype)
        else:
            self._evict_cold(need)
            slot = self._slot[pids]
            local = flat - pids * self.page_rows
            rows = _host_dequantize(
                self._slab[slot, local], None if self._slab_scales is None
                else self._slab_scales[slot, local], self.dtype)
        if out is None:
            return rows.reshape(shape + (self.dim,))
        out[...] = rows.reshape(out.shape)
        return out

    def materialize(self) -> np.ndarray:
        """The full (N, D) float32 corpus straight off the backing payload
        (bypasses, and never populates, the page cache)."""
        return _host_dequantize(np.asarray(self.data), None
                                if self.scales is None
                                else np.asarray(self.scales), self.dtype)


class PagedCorpusStore:
    """The paged twin of ``CorpusStore``: the payload lives behind a host
    ``_PageCache``; ``take`` gathers through the pager and hands back
    float32 rows on ``device``, equal to the whole store's ``take`` bit for
    bit. The tombstone words live on ``device`` beside it. The engine
    gathers one (Q, 1+B) block per step through ``cache.gather`` into a
    pinned host tile between the two captured halves of the step."""

    is_paged = True

    def __init__(self, cache: _PageCache,
                 tombstones: Optional[torch.Tensor] = None, device="cuda"):
        self.cache = cache
        self._device = resolve_device(device)
        if tombstones is not None and tuple(tombstones.shape) != (
                (cache.n + 31) // 32,):
            raise ValueError(f"tombstones must be ((N+31)//32,) words, got "
                             f"{tuple(tombstones.shape)}")
        self.tombstones = tombstones

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> str:
        return self.cache.dtype

    @property
    def policy(self) -> ResidencyPolicy:
        return self.cache.policy

    @property
    def n(self) -> int:
        return self.cache.n

    @property
    def dim(self) -> int:
        return self.cache.dim

    @property
    def stats(self) -> PageCacheStats:
        return self.stats_snapshot()

    def stats_snapshot(self) -> PageCacheStats:
        return dataclasses.replace(self.cache.stats)

    def set_read_hook(self,
                      hook: Optional[Callable[[int, int], None]]) -> None:
        """Install a fault-injection read hook (``_PageCache.read_hook``;
        typically ``FaultPlan.pager_hook()``). None uninstalls."""
        self.cache.read_hook = hook

    def set_tracer(self, tracer) -> None:
        """Route the pager's spans (page_fault / fallback, site "pager")
        into an ``obs.Tracer``; ``NULL_TRACER`` turns them off."""
        self.cache.tracer = tracer

    def bind_registry(self, registry, shard: str = "0"):
        """The eight ``repro_pager_*`` families of the JAX store, copied
        out of ``stats_snapshot()`` at exposition time."""
        labels = {"shard": str(shard)}
        c_hits = registry.counter("repro_pager_hits_total",
                                  "page-cache hits", labelnames=("shard",))
        c_faults = registry.counter("repro_pager_faults_total",
                                    "page faults (physical page reads)",
                                    labelnames=("shard",))
        c_evic = registry.counter("repro_pager_evictions_total",
                                  "LRU page evictions",
                                  labelnames=("shard",))
        c_retry = registry.counter("repro_pager_retries_total",
                                   "physical reads re-attempted after "
                                   "OSError", labelnames=("shard",))
        c_ioerr = registry.counter("repro_pager_io_errors_total",
                                   "OSErrors observed by the pager",
                                   labelnames=("shard",))
        g_res = registry.gauge("repro_pager_resident_bytes",
                               "current page-cache footprint",
                               labelnames=("shard",))
        g_peak = registry.gauge("repro_pager_peak_resident_bytes",
                                "page-cache footprint high-water mark",
                                labelnames=("shard",))
        g_fall = registry.gauge("repro_pager_degraded",
                                "1 when degraded to whole residency",
                                labelnames=("shard",))

        def _collect():
            st = self.stats_snapshot()
            c_hits.labels(**labels).set_to(st.hits)
            c_faults.labels(**labels).set_to(st.faults)
            c_evic.labels(**labels).set_to(st.evictions)
            c_retry.labels(**labels).set_to(st.retries)
            c_ioerr.labels(**labels).set_to(st.io_errors)
            g_res.labels(**labels).set(st.resident_bytes)
            g_peak.labels(**labels).set(st.peak_resident_bytes)
            g_fall.labels(**labels).set(1.0 if st.fallback else 0.0)

        registry.register_collect(_collect)
        return registry

    def take(self, ids) -> torch.Tensor:
        """Gather rows by id (any shape) through the pager -> (..., D)
        float32 on the store's device; ids clamp into [0, N)."""
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        rows = self.cache.gather(np.asarray(ids))
        return torch.from_numpy(rows).to(self.device)

    def dequantize(self) -> torch.Tensor:
        """The full (N, D) float32 corpus on the device (materializes it;
        reads the backing payload, never populates the cache)."""
        return torch.from_numpy(self.cache.materialize()).to(self.device)

    def nbytes(self) -> int:
        """Resident HOST bytes: the page cache's current footprint (the
        whole host copy once degraded), not the backing payload, and no
        device memory."""
        return int(self.cache.stats.resident_bytes)

    def with_tombstones(self,
                        flags: Optional[np.ndarray]) -> "PagedCorpusStore":
        """The same pager with the (N,) bool delete flags packed into new
        tombstone words (None clears them)."""
        words = None if flags is None else _words_tensor(pack_bitmap(flags),
                                                         self.device)
        return PagedCorpusStore(self.cache, words, self.device)

    def __repr__(self) -> str:
        return (f"PagedCorpusStore(n={self.n}, dim={self.dim}, "
                f"dtype={self.dtype}, page_rows={self.cache.page_rows}, "
                f"cache_bytes={self.policy.cache_bytes}, "
                f"device={self.device})")


AnyCorpusStore = Union[CorpusStore, PagedCorpusStore]


def make_paged_store(data: np.ndarray, corpus_dtype: str,
                     policy: ResidencyPolicy,
                     scales: Optional[np.ndarray] = None,
                     tombstones: Optional[np.ndarray] = None,
                     device="cuda") -> PagedCorpusStore:
    """A paged store over a payload already in residency format: numpy
    float32, uint16 bf16 bit patterns, or int8 with (N, 1) float32
    ``scales`` (typically ``np.load(..., mmap_mode="r")`` of io v3's
    files). ``tombstones``: (N,) bool delete flags, packed on ``device``,
    where the gathered rows go too."""
    if corpus_dtype == "int8" and scales is None:
        raise ValueError("int8 paged residency requires per-row scales")
    policy = as_policy(policy)
    if policy.kind != "paged":
        raise ValueError(f"make_paged_store needs a paged policy, got "
                         f"{policy.kind!r}")
    dev = resolve_device(device)
    cache = _PageCache(data, scales, corpus_dtype, policy)
    words = None if tombstones is None else _words_tensor(
        pack_bitmap(tombstones), dev)
    return PagedCorpusStore(cache, words, dev)


def _host_payload(store: CorpusStore) -> Tuple[np.ndarray,
                                              Optional[np.ndarray]]:
    """A whole store's payload as host numpy arrays in residency format
    (bf16 as uint16 bit patterns): what a paged store over it pages."""
    data = store.data.detach().cpu()
    if store.dtype == "bfloat16":
        data = data.view(torch.int16).numpy().view(np.uint16)
    else:
        data = data.numpy()
    scales = None if store.scales is None else store.scales.cpu().numpy()
    return data, scales


def make_corpus_store(base, corpus_dtype: str = "float32", device="cuda",
                      tombstones: Optional[np.ndarray] = None,
                      residency=None) -> AnyCorpusStore:
    """Quantize an (N, D) float corpus (numpy or tensor) into residency
    format on ``device``; ``tombstones`` are (N,) bool delete flags.
    ``residency`` (None / 'whole' / 'paged' / a ``ResidencyPolicy``): a
    paged policy quantizes on ``device`` exactly as the whole store does,
    then pages that payload from host memory (file-backed pages come from
    ``graph.io.load_corpus_store``), so both hold the same bits."""
    _check_dtype(corpus_dtype)
    policy = as_policy(residency)
    dev = resolve_device(device)
    if policy.kind == "paged":
        data, scales = _host_payload(make_corpus_store(base, corpus_dtype,
                                                      dev))
        return make_paged_store(data, corpus_dtype, policy, scales,
                                tombstones, dev)
    if isinstance(base, torch.Tensor):
        base = base.to(device=dev, dtype=torch.float32)
    else:
        base = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    data, scales = _quantize(base, corpus_dtype)
    words = None if tombstones is None else _words_tensor(
        pack_bitmap(tombstones), dev)
    return CorpusStore(data, scales, corpus_dtype, words)


def as_corpus_store(base: Union[torch.Tensor, np.ndarray, AnyCorpusStore],
                    corpus_dtype: str = "float32",
                    device="cuda") -> AnyCorpusStore:
    """A store in ``corpus_dtype`` passes through; a whole store in another
    dtype is re-quantized from its ``dequantize()`` and keeps its
    tombstones; a paged store in another dtype raises (re-quantizing would
    materialize the corpus); an array becomes a store on ``device`` (a
    tensor stays on its own device)."""
    _check_dtype(corpus_dtype)
    if isinstance(base, PagedCorpusStore):
        if base.dtype != corpus_dtype:
            raise ValueError(
                f"paged store holds {base.dtype!r} pages but the engine "
                f"wants {corpus_dtype!r}; rebuild the paged store in the "
                f"serving dtype (re-quantizing on the fly would materialize "
                f"the corpus and defeat paging)")
        return base
    if isinstance(base, CorpusStore):
        if base.dtype == corpus_dtype:
            return base
        data, scales = _quantize(base.dequantize(), corpus_dtype)
        return CorpusStore(data, scales, corpus_dtype, base.tombstones)
    if isinstance(base, torch.Tensor):
        device = base.device
    return make_corpus_store(base, corpus_dtype, device)


def store_from_arrays(data: np.ndarray, scales: Optional[np.ndarray],
                      dtype: str, tombstones: Optional[np.ndarray] = None,
                      device="cuda") -> CorpusStore:
    """A store holding exactly the given payload: numpy arrays of a JAX
    ``CorpusStore``'s leaves (float32, uint16 bf16 bit patterns, or int8
    with (N, 1) float32 scales; tombstones as uint32 words). Both sides then
    search the same bits."""
    _check_dtype(dtype)
    dev = resolve_device(device)
    data = np.asarray(data)
    if dtype == "bfloat16":
        if data.dtype != np.uint16:
            raise TypeError(f"bfloat16 payload must be uint16 bit patterns, "
                            f"got {data.dtype}")
        t = torch.tensor(data.view(np.int16), device=dev).view(
            torch.bfloat16)
    else:
        want = np.float32 if dtype == "float32" else np.int8
        if data.dtype != want:
            raise TypeError(f"{dtype} payload must be {np.dtype(want)}, got "
                            f"{data.dtype}")
        t = torch.tensor(data, device=dev)
    sc = None if scales is None else torch.tensor(
        np.asarray(scales, np.float32), device=dev)
    words = None if tombstones is None else _words_tensor(tombstones, dev)
    return CorpusStore(t, sc, dtype, words)
