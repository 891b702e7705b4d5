#!/usr/bin/env python3
"""Where the MLP grad kernel's time goes: device µs per call of cut-down
copies of it, timed in turns in one process at the serving shape (Q = 32
frontier rows, Dx = Dq = 40, MLP 80 -> 64 -> 64 -> 1, per-row queries),
each under CUDA-graph replay as ``chip_smoke.time_ms`` times the kernels.

Variants of the one-warp-per-row layout (``mlp_stage`` and
``mlp_forward_warp`` of ``csrc/mlp.cuh``, the score path's, at its grid of
Q / 8 blocks of 256 threads and its shared memory):

- ``warp_empty``: the launch alone, nothing done;
- ``warp_stage``: the whole network staged into shared memory;
- ``warp_forward``: staging and the forward pass of every row;

or, where the sources have ``mlp_grad.cuh`` (the cluster kernel), its
``Stop`` phases at its own cluster launch: ``cluster_empty``,
``cluster_stage``, ``cluster_forward`` (through the value); then
``kernel``: the sources' own ``mlp_grad_f32`` entry, whatever body it
launches; and ``floor``, an in-place add on a one-element tensor.

Splits this checkout's kernel, or each kernel source directory given with
``--csrc`` (another commit's ``src/repro_torch/kernels/csrc`` unpacked
with ``git archive`` into a directory that ``.gitignore`` lists, or an
edited copy), all timed in turns in one process (each copy is its own
library with plain C entry points). Prints one JSON line: per variant the
median over the rounds and each round's time, each copy's largest error
against the plain version, its ptxas lines and its SASS opcode counts,
and for a copy instrumented with clock64 stamps (one that defines
``extern "C" int mlp_grad_stamps(unsigned long long*)``, 32 counters) the
stamps of one run. The parent's split in PERF.md is this tool on the
parent's sources (``--csrc build/parent/src/repro_torch/kernels/csrc``).

    python3 tools/mlp_grad_split.py [--rounds 5] [--csrc DIR ...]
                                    [--sass-dir DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

Q, DX, DQ, HIDDEN = 32, 40, 40, (64, 64)

# cut-down copies of the grad kernel, over the score path's pieces; each
# entry takes the arguments of mlp_grad_f32 and launches one variant
VARIANTS_CU = r"""
#include "mlp.cuh"
#include "mlp_grad.cu"
using namespace repro;

// keep a variant's shared-memory work alive without writing anything
__device__ inline void sink(const float* sm, float* out, int M) {
  if (threadIdx.x == 0 && sm[M & 7] == 1234.5f) out[0] = sm[1];
}

__global__ void __launch_bounds__(kMLPThreads)
warp_empty(float* vals, int M) {
  if (M < 0) vals[0] = 0.f;
}

__global__ void __launch_bounds__(kMLPThreads)
warp_stage(MLPNet net, float* vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  sink(sm, vals, M);
}

__global__ void __launch_bounds__(kMLPThreads)
warp_forward(GatheredRows rows, const float* __restrict__ query,
             int q_shared, MLPNet net, float* __restrict__ vals, int M) {
  extern __shared__ float sm[];
  mlp_stage(sm, net);
  __syncthreads();
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* scr = sm + net.weight_floats + warp * net.scratch_floats;
  float* slice = scr + net.scratch_floats - net.dx;
  const int row0 = blockIdx.x * kMLPRowsPerBlock;
  const int row1 = min(row0 + kMLPRowsPerBlock, M);
  for (int r = row0 + warp; r < row1; r += blockDim.x / kWarp) {
    __syncwarp();
    const float* x = rows.load(r, net.dx, slice, lane);
    const float* q =
        q_shared ? query : query + static_cast<size_t>(r) * net.dq;
    const float val = mlp_forward_warp(sm, net, x, q, scr, lane);
    if (lane == 0) vals[r] = val;
  }
}

extern "C" int split_run(int variant, const void* cand, const void* query,
                         int q_shared, const void* const* ws,
                         const void* const* bs, const int* dims, int layers,
                         void* vals, void* grads, int M, int Dx, int Dq,
                         void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mlp_smem_bytes(net);
  const int grid = (M + kMLPRowsPerBlock - 1) / kMLPRowsPerBlock;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* v = static_cast<float*>(vals);
  switch (variant) {
    case 0:
      allow_smem(warp_empty, smem);
      warp_empty<<<grid, kMLPThreads, smem, s>>>(v, M);
      break;
    case 1:
      allow_smem(warp_stage, smem);
      warp_stage<<<grid, kMLPThreads, smem, s>>>(net, v, M);
      break;
    case 2:
      allow_smem(warp_forward, smem);
      warp_forward<<<grid, kMLPThreads, smem, s>>>(
          GatheredRows{static_cast<const float*>(cand)},
          static_cast<const float*>(query), q_shared, net, v, M);
      break;
    default:
      return mlp_grad_f32(cand, query, q_shared, ws, bs, dims, layers, vals,
                          grads, M, Dx, Dq, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# the cluster kernel's phases, where the checkout has it
CLUSTER_CU = r"""
extern "C" int split_cluster(int stop, const void* cand, const void* query,
                             int q_shared, const void* const* ws,
                             const void* const* bs, const int* dims,
                             int layers, void* vals, void* grads, int M,
                             int Dx, int Dq, void* stream) {
  MLPNet net;
  if (!mlp_net(net, ws, bs, dims, layers, Dx, Dq))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatheredRows rows{static_cast<const float*>(cand)};
  switch (stop) {
    case 0:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 0>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    case 1:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 1>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
    default:
      return static_cast<int>(launch_mlp_grad_cluster<GatheredRows, 2>(
          rows, query, q_shared, net, vals, grads, nullptr, M, stream));
  }
}
"""


def build(csrc, out_dir):
    """Compile the variants against the kernel sources in ``csrc`` into
    one library with the port's nvcc flags; returns (library, whether it
    has the cluster kernel, nvcc's output, the library's SASS)."""
    from repro_torch.kernels import _lib
    os.makedirs(out_dir, exist_ok=True)
    has_cluster = os.path.exists(os.path.join(csrc, "mlp_grad.cuh"))
    src = os.path.join(out_dir, "mlp_grad_split.cu")
    with open(src, "w") as f:
        f.write(VARIANTS_CU + (CLUSTER_CU if has_cluster else ""))
    so = os.path.join(out_dir, "libmlp_grad_split.so")
    cmd = [_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", csrc, "-shared", "-o", so,
           src]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{out.stdout}\n{out.stderr}")
    sass = subprocess.run(
        [os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump"), "-sass",
         so], capture_output=True, text=True).stdout
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    names = ["split_run"] + (["split_cluster"] if has_cluster else [])
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = [I, P, P, I, P, P, P, I, P, P, I, I, I, P]
        fn.restype = I
    return lib, has_cluster, out.stdout + out.stderr, sass


def sass_opcodes(sass: str, kernel: str) -> dict:
    """Opcode counts of each function whose name holds ``kernel``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            fn = fn if kernel in fn else None
        elif fn and "/*" in line and ";" in line:
            op = line.split("*/", 1)[1].strip().split()
            if op and op[0].startswith("@"):
                op = op[1:]
            if op:
                name = op[0].rstrip(";")
                counts.setdefault(fn, {})
                counts[fn][name] = counts[fn].get(name, 0) + 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--csrc", nargs="*", default=None,
                    help="kernel source directories to split, each timed "
                         "in turns with the others (default: this "
                         "checkout's)")
    ap.add_argument("--sass-dir", default=None,
                    help="also write each copy's SASS of the grad kernels "
                         "to this directory")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mlp_grad_split: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _lib
    from repro_torch.kernels.mlp_grad.ref import mlp_value_and_grad_ref
    from repro_torch.kernels.mlp_score.ops import net_args

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device="cpu").manual_seed(456)
    net = chip_smoke.random_mlp(torch, dev, DX + DQ, HIDDEN, gen)
    c = torch.randn((Q, DX), generator=gen).to(dev)
    q = torch.randn((Q, DQ), generator=gen).to(dev)
    args = net_args(net["w"], net["b"], DX, dev)
    vals = torch.empty((Q,), device=dev)
    grads = torch.empty((Q, DX), device=dev)
    pv, pg = mlp_value_and_grad_ref(c, q, net["w"], net["b"])

    def call(fn, variant):
        def run():       # on the current stream: time_ms captures a graph
            rc = fn(variant, c.data_ptr(), q.data_ptr(), 0, *args,
                    vals.data_ptr(), grads.data_ptr(), Q, DX, DQ,
                    _lib.stream_of(dev))
            _lib.check(rc, f"variant {variant}")
        return run

    out = {"device": chip_smoke.nvidia_smi_line(), "unit": "us",
           "shape": f"Q={Q} Dx={DX} Dq={DQ} hidden={HIDDEN}", "err": {},
           "ptxas": {}, "sass_opcodes": {}}
    calls = {}
    for i, csrc in enumerate(opts.csrc or [str(_lib.CSRC)]):
        label = os.path.basename(os.path.normpath(csrc)) + (
            f"#{i}" if opts.csrc else "")
        lib, has_cluster, log, sass = build(
            csrc, os.path.join(ROOT, "build", "mlp_grad_split", str(i)))
        if has_cluster:
            names = ("cluster_empty", "cluster_stage", "cluster_forward")
            fn = lib.split_cluster
        else:
            names = ("warp_empty", "warp_stage", "warp_forward")
            fn = lib.split_run
        for v, name in enumerate(names):
            calls[f"{label}:{name}"] = call(fn, v)
        calls[f"{label}:kernel"] = call(lib.split_run, 3)
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        out["err"][label] = max(float((vals - pv).abs().max()),
                                float((grads - pg).abs().max()))
        out["ptxas"][label] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        out["sass_opcodes"][label] = sass_opcodes(sass, "mlp_grad")
        if opts.sass_dir:
            os.makedirs(opts.sass_dir, exist_ok=True)
            with open(os.path.join(opts.sass_dir, f"{label}.sass"), "w") as f:
                f.write(sass)
        try:            # a copy instrumented with clock64 stamps
            stamps = lib.mlp_grad_stamps
        except AttributeError:
            continue
        buf = (ctypes.c_ulonglong * 32)()
        calls[f"{label}:kernel"]()
        torch.cuda.synchronize()
        _lib.check(stamps(buf), "mlp_grad_stamps")
        out.setdefault("stamps", {})[label] = list(buf)
    one = torch.zeros(1, device=dev)
    calls["floor"] = lambda: one.add_(1.0)
    times = {k: [] for k in calls}
    for _ in range(opts.rounds):
        for k, fn in calls.items():
            times[k].append(chip_smoke.time_ms(fn) * 1e3)
    out["median_us"] = {k: statistics.median(v) for k, v in times.items()}
    out["rounds_us"] = times
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
