#!/usr/bin/env python3
"""Times of the port's Yi-9B decode step as ``chip_smoke.py`` phase 13 (c)
reads them, printed as one JSON line: Yi-9B at full width, 48 layers,
bf16, ``decode_32k`` with the batch cut to 8, a 32,768-token cache drawn
from a generator; 32 greedy steps on the host clock (no sync inside) and
between CUDA events, five runs; and the host µs of one eager
``decode_attention`` call: its issue alone (200 calls on a 256-position
cache, which the card runs faster than the host issues them, the host
clock read before the sync) and one call on a layer's full cache
(synchronised at the end of 200 calls: the device time).

Times the port of the checkout this file sits in. To compare two commits
on one card, unpack the other with ``git archive`` into a directory that
``.gitignore`` lists, copy this file into its ``tools/``, and run the two
in turns (parent, change, change, parent), each in its own process.

    python3 tools/decode_step_times.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, T, STEPS, RUNS = 8, 32768, 32, 5


def main() -> None:
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import decode_attention
    from repro_torch.models import transformer as tf
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch("yi-9b").make_config(),
                              dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = tf.init_params(gen, cfg, device=dev)
    cache = {}
    for k in ("k", "v"):
        cache[k] = torch.empty((cfg.n_layers, B, T, cfg.n_kv_heads,
                                cfg.head_dim), dtype=cfg.dtype, device=dev)
        for i in range(cfg.n_layers):
            cache[k][i].normal_(generator=gen)
    pos0 = T - STEPS - 2
    tok0 = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=dev)

    def steps(n):
        tok = tok0
        pos = torch.tensor([pos0], dtype=torch.int32, device=dev)
        for _ in range(n):
            lg, _ = tf.decode_step(params, cache, tok, pos, cfg)
            tok = lg[:, :cfg.vocab_size].argmax(dim=-1)
            pos += 1
        return lg

    steps(2)                                             # warm
    runs = []
    for _ in range(RUNS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        steps(STEPS)
        end.record()
        torch.cuda.synchronize()
        runs.append({"host_ms_per_step": (time.perf_counter() - t0)
                     / STEPS * 1e3,
                     "device_ms_per_step": start.elapsed_time(end) / STEPS})
    q = torch.randn((B, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=dev).to(cfg.dtype)

    def per_call_us(kc, vc, length, until_done):
        for _ in range(10):
            decode_attention(q, kc, vc, length)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            decode_attention(q, kc, vc, length)
        if not until_done:
            t1 = time.perf_counter()
        torch.cuda.synchronize()
        if until_done:
            t1 = time.perf_counter()
        return (t1 - t0) / 200 * 1e6

    small = (cache["k"][0][:, :256].contiguous(),
             cache["v"][0][:, :256].contiguous())
    issue_us = per_call_us(*small, torch.tensor([200], dtype=torch.int32,
                                                device=dev), False)
    call_us = per_call_us(cache["k"][0], cache["v"][0],
                          torch.tensor([pos0], dtype=torch.int32,
                                       device=dev), True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"root": ROOT, "card": smi, "B": B, "T": T,
                      "steps": STEPS, "runs": runs,
                      "decode_attention_issue_us": issue_us,
                      "decode_attention_call_us": call_us}), flush=True)


if __name__ == "__main__":
    main()
