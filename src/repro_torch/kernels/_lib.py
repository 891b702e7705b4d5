"""Build and load the port's CUDA kernels: one shared library from every
``csrc/*.cu``, compiled with ``nvcc`` for ``sm_90a`` at first use and bound
with ``ctypes`` (plain C entry points, no PyTorch headers).

The library lands in ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout, keyed on a hash of the sources and flags, so an edited kernel
is rebuilt and an unchanged one is loaded as it is. Each source compiles in
its own ``nvcc`` process, all started together, then one link step joins
them. Nothing here runs at import: the CPU tests import every module of the
port on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong

# C entry point -> argtypes; every entry returns cudaGetLastError()
SIGNATURES = {
    # cand, query, q_shared, w0, b0, w1, b1, w2, b2, out,
    # M, D, fm_dim, H0, H1, stream
    "deepfm_score_f32": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _P],
    # cand, query, q_shared, w0, b0, w1, b1, w2, b2, vals, grads,
    # M, D, fm_dim, H0, H1, stream
    "deepfm_grad_f32": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _P],
    # x, grad, nvecs, valid(u8), key, mask(u8), Q, B, D, alpha,
    # by_angle, stream
    "neighbor_rank_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    # data, scales, ids(i64), residency, query, q_shared, mask(u8|NULL),
    # w0, b0, w1, b1, w2, b2, out, M, D, fm_dim, H0, H1, stream
    "deepfm_score_fused": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _I, _I, _I, _P],
    # data, scales, ids(i64), residency, query, q_shared, w0, b0, w1, b1,
    # w2, b2, vals, grads, x, M, D, fm_dim, H0, H1, stream
    "deepfm_grad_fused": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # x, grad, data, scales, ids(i64), residency, valid(u8), key, mask(u8),
    # Q, B, D, alpha, by_angle, stream
    "neighbor_rank_fused": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I,
                            _F, _I, _P],
    # The MLP kernels take the network as arrays: ws and bs (void*[L]),
    # dims (int[L + 1], dims[0] = Dx + Dq, dims[L] = 1) and the depth L.
    # cand, query, q_shared, ws, bs, dims, L, out, M, Dx, Dq, stream
    "mlp_score_f32": [_P, _P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P],
    # cand, query, q_shared, ws, bs, dims, L, vals, grads, M, Dx, Dq, stream
    "mlp_grad_f32": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
    # data, scales, ids(i64), residency, query, q_shared, mask(u8|NULL),
    # ws, bs, dims, L, out, M, Dx, Dq, stream
    "mlp_score_fused": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _P, _I,
                        _I, _I, _P],
    # dims, L, Dx, Dq, info (int[4]): the score's plan at these widths
    "mlp_score_plan_info": [_P, _I, _I, _I, _P],
    # D, fm_dim, H0, H1, info (int[5]): the DeepFM score's plan at these
    # widths
    "deepfm_score_plan_info": [_I, _I, _I, _I, _P],
    # B, D, info (int[9]): the rank pair's plan at these widths
    "neighbor_rank_plan_info": [_I, _I, _P],
    # data, scales, ids(i64), residency, query, q_shared, ws, bs, dims, L,
    # vals, grads, x, M, Dx, Dq, stream
    "mlp_grad_fused": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _P],
    # The library kernels take a dtype code (DTYPE: float32 0, bfloat16 1).
    # table, dtype, R, d, idx, idx64, weights|NULL, out, B, L, stream
    "embedding_bag": [_P, _I, _LL, _I, _P, _I, _P, _P, _I, _I, _P],
    # q, q_f32, k, v, dtype, length(i32*)|NULL, length, B, T, KV, G, hd,
    # chunk, n_chunks, part_acc, part_ml, out, stream
    "decode_attention": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P, _P, _P, _P],
    # the same without dtype (a bfloat16 cache)
    "decode_attention_tc": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P],
    # q, k, v, strides (long long[9]), out, B, S, H, hd, stream: bfloat16
    # at hd = 8 (CUDA cores), bfloat16 at hd >= 16 (wgmma), float32 (3xTF32)
    "flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "flash_attention_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "flash_attention_tf32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

# CorpusStore.dtype -> the kernels' residency code (csrc/rows.cuh)
RESIDENCY = {"float32": 0, "bfloat16": 1, "int8": 2}
# tensor dtype -> the library kernels' dtype code (csrc/elem.cuh)
DTYPE = {torch.float32: 0, torch.bfloat16: 1}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


class CudaKernelError(RuntimeError):
    """The kernel library failed to build (``nvcc`` missing or failing) or
    a kernel's launch failed (``cudaGetLastError()`` non-zero). A fault of
    the port or the card, never of one request: the sharded serving
    runtime's fault domains let it propagate."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise CudaKernelError("nvcc not found (PATH or $CUDA_HOME/bin); the "
                          "CUDA kernels build only where the CUDA toolkit "
                          "is installed")


def build(force: bool = False) -> Path:
    """Compile the library if it is not built for these sources; returns
    its path. Compiler output (``-Xptxas -v``: registers, shared memory,
    spills per kernel) is kept beside it in ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists() and not force:
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    stage = BUILD_ROOT / f".build-{os.getpid()}"
    shutil.rmtree(stage, ignore_errors=True)
    stage.mkdir(parents=True)
    try:
        srcs = sorted(CSRC.glob("*.cu"))
        procs = []
        for src in srcs:
            obj = stage / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise CudaKernelError(f"nvcc failed for {failed}:\n"
                                  + "\n".join(log))
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(stage / lib_path.name),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc={link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise CudaKernelError("nvcc link failed:\n" + "\n".join(log))
        (stage / "build.log").write_text("\n".join(log))
        shutil.rmtree(out_dir, ignore_errors=True)
        stage.rename(out_dir)
    finally:
        shutil.rmtree(stage, ignore_errors=True)
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False)
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_smem_optin.argtypes = [ctypes.c_int]
        lib.repro_smem_optin.restype = ctypes.c_int
        lib.decode_attention_tc_resident.argtypes = [ctypes.c_int,
                                                     ctypes.c_int]
        lib.decode_attention_tc_resident.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a C entry point."""
    if rc != 0:
        msg = load().repro_cuda_error_string(rc).decode()
        raise CudaKernelError(f"{name}: CUDA error {rc} ({msg})")


def require(t, name: str, device, shape, dtype=None) -> None:
    """Validate a kernel argument: a tensor on ``device``, of ``shape``
    (None entries match any size), contiguous, of ``dtype`` (float32 by
    default). Raises ValueError/TypeError naming the argument."""
    import torch
    dtype = torch.float32 if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def corpus_args(store):
    """The corpus arguments of an index-fused kernel: (data pointer, scales
    pointer or None, residency code)."""
    scales = None if store.scales is None else store.scales.data_ptr()
    return store.data.data_ptr(), scales, RESIDENCY[store.dtype]


@functools.lru_cache(maxsize=None)
def smem_optin(index: int) -> int:
    """The most dynamic shared memory (bytes) a block may opt in to on card
    ``index``, as the CUDA runtime reports it."""
    n = load().repro_smem_optin(index)
    if n < 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:"
                           f"{index}")
    return n


CPU_ROW_BLOCK = 64   # rows per call of a plain version on the CPU


def cpu_row_blocks(fn, *rows, block: int = CPU_ROW_BLOCK):
    """``fn(*rows)`` for a wrapper's CPU path, run over fixed blocks of
    ``block`` rows (dim 0 of each of ``rows``, the last block zero-padded;
    None passes through), its outputs (a tensor or a tuple) concatenated
    and cut back to the rows given. The CPU's BLAS picks its order of
    summation by the number of rows, so without the blocks a row's value
    would depend on how many rows came with it, and the continuous runtime
    and the oneshot search, which hand one query's rows over in batches of
    different sizes, could part by an ulp. The blocks run on one intra-op
    thread: they are small, and a team of BLAS threads spinning beside
    other processes cost the CPU tests far more than it gave."""
    import torch
    n = next(r.shape[0] for r in rows if r is not None)
    pad = -n % block
    if pad:
        rows = tuple(None if r is None else torch.cat(
            [r, r.new_zeros((pad,) + tuple(r.shape[1:]))]) for r in rows)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = [fn(*(None if r is None else r[i:i + block] for r in rows))
                for i in range(0, max(n + pad, 1), block)]
    finally:
        torch.set_num_threads(threads)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts)[:n] for parts in zip(*outs))
    return torch.cat(outs)[:n]


def stream_of(device) -> int:
    """The current CUDA stream's handle on ``device``, for a C launcher."""
    return torch.cuda.current_stream(device).cuda_stream
