"""Shared set-up of the tools: paths, caches, and a set-up clock that
records nothing."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def prepare() -> None:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.path[:0] = [str(ROOT / "portbench")]
    import run  # noqa: F401  (the benchmark's cache settings)
    run.set_cache_dirs()
    sys.path.remove(str(ROOT / "portbench"))


class NoSetup:
    total = 0.0

    def mark(self, name):
        pass

    def add(self, name, seconds):
        pass

    def finish(self):
        return 0.0
