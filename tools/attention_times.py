#!/usr/bin/env python3
"""Device times of the port's attention wrappers at Yi-9B widths (H=32,
KV=4, hd=128), printed as one JSON line: flash ``train_4k`` f32 B=1 alone
(first in the process), then bf16 B=8 and f32 B=1 once more right after
it (the order ``chip_smoke.py`` times them in; the first calls after the
bf16 case are also read one by one); decode ``decode_32k`` (f32 B=32,
bf16 B=128, then f32 B=32 once more right after the bf16 case) and
``long_500k``. Each decode case first holds the kernel against its plain
version and makes the SDPA copies, as ``chip_smoke.py`` does, then reads
the kernel three times (CUDA events over eager calls), the plain version
and SDPA once; each flash case reads the kernel and SDPA (over the
(B, H, S, hd) copies ``chip_smoke.py`` makes). The first f32 decode case
and the lone f32 flash case also give, from ``torch.profiler``, the device
time of each kernel that the wrapper launches, and the flash case that of
each kernel that SDPA's float32 call launches (its name says which
backend PyTorch chose).

Times the port of the checkout this file sits in. To compare two commits
on one card, unpack the other with ``git archive`` into a directory that
``.gitignore`` lists, copy this file into its ``tools/``, and run the two
in turns (parent, change, change, parent), each in its own process.

    python3 tools/attention_times.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

H, KV, HD = 32, 4, 128      # Yi-9B (src/repro/configs/yi_9b.py)
SEED = 22


def event_ms(fn, reps: int, warm: int = 1) -> float:
    """Device ms of one call: ``warm`` calls, then ``reps`` eager calls
    between two CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def kernel_us(fn, calls: int = 10) -> dict:
    """Device µs per call of each kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) \
            or getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key[:60]] = t / calls
    return out


def decode_case(torch, B, T, dt, split=False):
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attn.ref import decode_attention_ref
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn((B, H, HD), device=dev, generator=g).to(dt)
    kc, vc = (torch.randn((B, T, KV, HD), device=dev, generator=g, dtype=dt)
              for _ in range(2))
    length = torch.tensor([T], dtype=torch.int32, device=dev)
    want = decode_attention_ref(q, kc, vc, length)
    res = {"max_abs_err": float(
        (decode_attention(q, kc, vc, length) - want).abs().max())}
    del want
    qg = q.reshape(B, KV, H // KV, HD)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    prefix = (torch.arange(T, device=dev) < length)[None, None, None, :]
    call = lambda: decode_attention(q, kc, vc, length)  # noqa: E731
    res["ms"] = [event_ms(call, reps=10) for _ in range(3)]
    res["plain_ms"] = event_ms(
        lambda: decode_attention_ref(q, kc, vc, length), reps=3)
    res["sdpa_ms"] = event_ms(lambda: F.scaled_dot_product_attention(
        qg, kt, vt, attn_mask=prefix), reps=10)
    if split:
        res["kernel_us"] = kernel_us(call)
    del q, kc, vc, kt, vt, qg
    torch.cuda.empty_cache()
    return res


def call_ms(fn, calls: int) -> list:
    """Device ms of each of ``calls`` single eager calls, no warm-up: a
    transient right after an earlier case shows in the first ones."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(calls + 1)]
    ev[0].record()
    for i in range(calls):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(calls)]


def flash_case(torch, B, dt, first_calls=0, split=False):
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn((B, 4096, H, HD), device=dev, generator=g,
                           dtype=dt) for _ in range(3))
    call = lambda: flash_attention(q, k, v)  # noqa: E731
    res = {}
    if first_calls:
        res["first_calls_ms"] = call_ms(call, first_calls)
    res["ms"] = [event_ms(call, reps=5) for _ in range(2)]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    res["sdpa_ms"] = event_ms(sdpa, reps=5)
    if split:
        res["kernel_us"] = kernel_us(call)
        res["sdpa_kernel_us"] = kernel_us(sdpa)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_times: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out = {"root": ROOT, "nvidia_smi": smi}
    out["flash train_4k f32 B=1 alone"] = flash_case(torch, 1, torch.float32,
                                                     split=True)
    out["flash train_4k bf16 B=8"] = flash_case(torch, 8, torch.bfloat16)
    out["flash train_4k f32 B=1"] = flash_case(torch, 1, torch.float32,
                                               first_calls=10)
    out["decode_32k f32 B=32"] = decode_case(torch, 32, 32768,
                                             torch.float32, split=True)
    out["decode_32k bf16 B=128"] = decode_case(torch, 128, 32768,
                                               torch.bfloat16)
    out["decode_32k f32 B=32 after bf16"] = decode_case(torch, 32, 32768,
                                                        torch.float32)
    out["long_500k bf16"] = decode_case(torch, 1, 524288, torch.bfloat16)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
