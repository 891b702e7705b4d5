"""The benchmark's one command:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` on the card it is started on and
prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each number the judge compared beside
its limit (also the last lines of standard error). The set-up's split is
printed on standard error before them.

It exits non-zero and prints no result when no card is available (or
fewer than the cell asks for), when the program's sources are not beside
it, or when JAX or the JAX package (``repro``) has been loaded."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def process_start() -> float:
    """The wall-clock time this process started (from /proc where it can
    be read, else now)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = process_start()
ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int) -> int:
    print(f"[portbench] {msg}", file=sys.stderr)
    return code


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the kernel library builds under build/ by itself)."""
    cache = ROOT / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    # the step plan comes from the shipped defaults: no local tuning file
    os.environ["REPRO_TORCH_TUNING_CACHE"] = str(cache / "tuning.json")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir() \
            or not (ROOT / "BENCHMARK.json").is_file():
        return fail(f"the program's sources (src/repro_torch) or "
                    f"BENCHMARK.json are not in {ROOT}", 2)
    set_cache_dirs()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import guard, harness, manifest

    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                    f"torch.cuda.is_available() is "
                    f"{torch.cuda.is_available()}, device_count "
                    f"{torch.cuda.device_count()}", 3)
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START,
                              manifest=man)
    card = power_limit()
    result.pop("_run")
    found = guard.loaded()
    if found:
        return fail(f"JAX or the JAX package was loaded: {found}", 4)
    result["card"] = card
    checks = result.pop("checks")
    result["checks"] = checks          # the last key
    print(f"[portbench] card {card}", file=sys.stderr)
    for name, c in checks.items():
        print(f"[portbench] check {name} {c['value']!r} {c['op']} "
              f"{c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
