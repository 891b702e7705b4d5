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

Paged residency (``PagedCorpusStore``, ``ResidencyPolicy``) is not ported
yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device

CORPUS_DTYPES = ("float32", "bfloat16", "int8")
_EPS = 1e-8


def _check_dtype(corpus_dtype: str) -> None:
    if corpus_dtype not in CORPUS_DTYPES:
        raise ValueError(f"corpus_dtype must be one of {CORPUS_DTYPES}, "
                         f"got {corpus_dtype!r}")


def refuse_paged(residency) -> None:
    """Raise for a paged residency policy (``'paged'`` or an object whose
    ``kind`` is ``'paged'``): not ported yet."""
    kind = getattr(residency, "kind", residency)
    if kind not in (None, "whole"):
        if kind == "paged":
            raise NotImplementedError(
                "paged residency (PagedCorpusStore) is not ported yet "
                "(ROADMAP.md, queue 1); v3 files load whole")
        raise ValueError(f"unknown residency {kind!r}")


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


def _words_tensor(words: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(words, np.uint32).astype(np.int64),
                           device=device)


def _quantize(base: torch.Tensor, corpus_dtype: str):
    if corpus_dtype == "bfloat16":
        return base.to(torch.bfloat16), None
    if corpus_dtype == "int8":
        return quantize_rows_int8(base)
    return base, None


def make_corpus_store(base, corpus_dtype: str = "float32", device="cuda",
                      tombstones: Optional[np.ndarray] = None
                      ) -> CorpusStore:
    """Quantize an (N, D) float corpus (numpy or tensor) into residency
    format on ``device``; ``tombstones`` are (N,) bool delete flags."""
    _check_dtype(corpus_dtype)
    dev = resolve_device(device)
    if isinstance(base, torch.Tensor):
        base = base.to(device=dev, dtype=torch.float32)
    else:
        base = torch.as_tensor(np.asarray(base, np.float32), device=dev)
    data, scales = _quantize(base, corpus_dtype)
    words = None if tombstones is None else _words_tensor(
        pack_bitmap(tombstones), dev)
    return CorpusStore(data, scales, corpus_dtype, words)


def as_corpus_store(base: Union[torch.Tensor, np.ndarray, CorpusStore],
                    corpus_dtype: str = "float32",
                    device="cuda") -> CorpusStore:
    """A store in ``corpus_dtype`` passes through; a store in another dtype
    is re-quantized from its ``dequantize()`` and keeps its tombstones; an
    array becomes a store on ``device`` (a tensor stays on its own
    device)."""
    _check_dtype(corpus_dtype)
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
