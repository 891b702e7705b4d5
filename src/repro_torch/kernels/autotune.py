"""The tuning cache and the engine step's tile plan; the JAX package's
``kernels/autotune.py`` with the same public names, precedence and cache
format.

The fused engine step has one structural knob that wall-clock cares about
and the bytes model does not, its dataflow ``plan``:

- ``rowwise`` hands ``(store, ids)`` to the index-fused stages: the fused
  kernels (``neighbor_rank_fused``, ``deepfm_score_fused`` /
  ``mlp_score_fused``, ``deepfm_grad_fused`` / ``mlp_grad_fused``) gather
  and dequantize the rows themselves.
- ``tile`` gathers the step's rows ONCE, one combined ``[frontier |
  neighbors]`` (Q, 1+B) block (``store.take``, dequantized), and runs the
  pre-gathered kernels (``neighbor_rank``, ``deepfm_score`` / ``mlp_score``,
  ``deepfm_value_and_grad`` / ``mlp_value_and_grad``) on slices of it.

On the card both are real choices: the fused kernels save the gathers, the
tile plan runs the cheaper pre-gathered kernels behind a few more PyTorch
ops. Neither is derivable from shapes alone, so plans are *measured*: a
candidate sweep per ``(backend, kernel, Q, B_or_C, D, dtype)`` key, the
winner persisted to a JSON tuning cache. Lookup precedence, most specific
measurement first:

1. an explicit override (``EngineOptions(tile=...)`` / ``serve --tile``),
2. the local cache: the exact key, then the ``backend|kernel|*`` wildcard,
3. the shipped defaults (``tuning_defaults.json`` beside this module, the
   same two-step lookup),
4. the builtin fallback (``rowwise``, ``bt=8``).

Exact keys beat wildcards across the two files: local exact > shipped exact
> local wildcard > shipped wildcard. A sweep whose exact key is already in
the local cache is skipped (the second run is free); shipped defaults never
suppress a requested sweep. A corrupt, oddly shaped or garbage-valued cache
warns (``RuntimeWarning``) and falls through to the next level.

Where this differs from the JAX module:

- **Backend.** A key's backend is the search's device type (``"cuda"`` or
  ``"cpu"``), which every caller passes; there is no global default
  backend (``backend=None`` raises).
- **Files.** The local cache is ``$REPRO_TORCH_TUNING_CACHE`` if set, else
  ``./.tuning_cache.torch.json`` (gitignored), so the JAX package's cache
  (``$REPRO_TUNING_CACHE`` / ``./.tuning_cache.json``) never steers the
  port, nor the other way round. The shipped defaults hold only
  ``cuda|engine_step|...`` entries from a sweep on the card; their
  ``comment`` names the card and its power limit.
- **bt** (rows per grid step of the JAX wide-block kernels) is parsed,
  merged, recorded and reported, and changes nothing on the card: the
  Hopper kernels fix their rows per CTA or cluster themselves. The
  per-kernel keys of ``TUNABLE_KERNELS`` stay resolvable; no wrapper reads
  them.
- **tune_engine_step** times a whole search per candidate plan through
  the captured programs, with ``torch.cuda.synchronize`` around each
  timed run, and keeps the least of ``reps``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import tempfile
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

_DEFAULTS_PATH = pathlib.Path(__file__).with_name("tuning_defaults.json")
_ENV_VAR = "REPRO_TORCH_TUNING_CACHE"
_DEFAULT_FILE = ".tuning_cache.torch.json"

#: tuning-cache accounting (process-lifetime totals), read by
#: ``bind_registry``; lookups themselves stay file-backed
CACHE_STATS = {"lookup_hits": 0, "lookup_misses": 0,
               "sweeps": 0, "sweep_cache_hits": 0}


def bind_registry(registry):
    """Adapter into an ``obs.Registry``: the cache traffic as counters,
    collected at exposition time from ``CACHE_STATS``."""
    c_hit = registry.counter("repro_autotune_lookup_hits_total",
                             "tile-config lookups answered from cache or "
                             "shipped defaults")
    c_miss = registry.counter("repro_autotune_lookup_misses_total",
                              "tile-config lookups falling to the builtin "
                              "default")
    c_sweep = registry.counter("repro_autotune_sweeps_total",
                               "measured tile sweeps actually run")
    c_skip = registry.counter("repro_autotune_sweep_cache_hits_total",
                              "requested sweeps skipped on a local cache "
                              "hit")

    def _collect():
        c_hit.set_to(CACHE_STATS["lookup_hits"])
        c_miss.set_to(CACHE_STATS["lookup_misses"])
        c_sweep.set_to(CACHE_STATS["sweeps"])
        c_skip.set_to(CACHE_STATS["sweep_cache_hits"])

    registry.register_collect(_collect)
    return registry


#: kernels with a tunable entry (the engine-step plan plus the fused pairs)
TUNABLE_KERNELS = (
    "engine_step", "neighbor_rank_fused", "deepfm_score_fused",
    "deepfm_grad_fused", "mlp_score_fused", "mlp_grad_fused",
)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One tuning decision. ``plan`` is only meaningful for ``engine_step``;
    ``bt`` is the JAX kernels' rows per grid step (inert on the card). Both
    fields always carry values so a config can be recorded for either kind
    of key."""
    plan: str = "rowwise"        # engine fused-step dataflow: rowwise | tile
    bt: int = 8                  # rows per grid step (JAX kernels only)

    def merged_over(self, base: "TileConfig") -> "TileConfig":
        return TileConfig(plan=self.plan or base.plan, bt=self.bt or base.bt)


def parse_tile(spec: Optional[str]) -> Optional[TileConfig]:
    """Parse an override spec: ``"tile"`` / ``"rowwise"`` (plan only),
    ``":16"`` (bt only), ``"tile:16"`` (both). Unset fields are 0 / "" so
    ``resolve`` can merge them over the looked-up config."""
    if spec is None or spec == "":
        return None
    plan, _, bts = str(spec).partition(":")
    if plan not in ("", "tile", "rowwise"):
        raise ValueError(f"bad tile spec {spec!r}: plan must be "
                         "'tile' or 'rowwise'")
    bt = int(bts) if bts else 0
    if bts and bt < 1:
        raise ValueError(f"bad tile spec {spec!r}: bt must be >= 1")
    return TileConfig(plan=plan, bt=bt)


# ---------------------------------------------------------------------------
# cache IO
# ---------------------------------------------------------------------------

def cache_path() -> str:
    return os.environ.get(_ENV_VAR, os.path.join(os.getcwd(),
                                                 _DEFAULT_FILE))


def _load_entries(path) -> Dict[str, dict]:
    """Entries of a cache file: {} for a missing file; a file that exists
    and will not parse, or has no 'entries' mapping, warns once and reads
    as {} (plans fall back to the next precedence level)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError:
        return {}
    except ValueError:
        warnings.warn(
            f"tuning cache at {path!r} is corrupt (unparsable JSON); "
            f"ignoring it — plans fall back to shipped defaults. Delete "
            f"the file or re-run autotune to repair it.",
            RuntimeWarning, stacklevel=2)
        return {}
    entries = doc.get("entries", {}) if isinstance(doc, dict) else None
    if not isinstance(entries, dict):
        warnings.warn(
            f"tuning cache at {path!r} has an unexpected layout (no "
            f"'entries' mapping); ignoring it — plans fall back to "
            f"shipped defaults.", RuntimeWarning, stacklevel=2)
        return {}
    return entries


def load_cache() -> Dict[str, dict]:
    """The local (measured) entries; {} when no cache file exists yet."""
    return _load_entries(cache_path())


def save_cache(entries: Dict[str, dict]) -> str:
    """Atomic write (tmp + rename): concurrent writers never leave a torn
    file behind."""
    path = cache_path()
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".tuning_cache.", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"version": 1, "entries": entries}, f, indent=1,
                      sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def shipped_defaults() -> Dict[str, dict]:
    return _load_entries(_DEFAULTS_PATH)


def _backend(backend: Optional[str]) -> str:
    if backend is None:
        raise ValueError("the tuning key needs a backend: the search's "
                         "device type ('cuda' or 'cpu')")
    return str(backend)


def make_key(kernel: str, q: int, m: int, d: int, dtype: str,
             backend: Optional[str] = None) -> str:
    """``backend|kernel|Q{q}|M{m}|D{d}|{dtype}``: M is B (neighbor degree)
    or C (flattened candidates) depending on the kernel; 0 for don't-care
    dims."""
    return (f"{_backend(backend)}|{kernel}|Q{int(q)}|M{int(m)}|D{int(d)}"
            f"|{dtype}")


def _wildcard(kernel: str, backend: Optional[str]) -> str:
    return f"{_backend(backend)}|{kernel}|*"


def _from_entry(entry: Optional[dict]) -> Optional[TileConfig]:
    if not isinstance(entry, dict):
        return None
    try:
        plan = str(entry.get("plan", "rowwise"))
        bt = int(entry.get("bt", 8))
    except (TypeError, ValueError):
        # garbage inside a parsable entry ("bt": "fast") skips the entry:
        # the lookup falls through to the next precedence level
        return None
    if plan not in ("tile", "rowwise") or bt < 1:
        return None
    return TileConfig(plan=plan, bt=bt)


def lookup(kernel: str, q: int = 0, m: int = 0, d: int = 0,
           dtype: str = "float32",
           backend: Optional[str] = None) -> Optional[TileConfig]:
    """Cache, then shipped defaults, the exact key before the backend
    wildcard."""
    key = make_key(kernel, q, m, d, dtype, backend)
    wild = _wildcard(kernel, backend)
    local = load_cache()
    shipped = shipped_defaults()
    for entry in (local.get(key), shipped.get(key), local.get(wild),
                  shipped.get(wild)):
        cfg = _from_entry(entry)
        if cfg is not None:
            CACHE_STATS["lookup_hits"] += 1
            return cfg
    CACHE_STATS["lookup_misses"] += 1
    return None


def resolve(kernel: str, *, q: int = 0, m: int = 0, d: int = 0,
            dtype: str = "float32", override: Optional[TileConfig] = None,
            backend: Optional[str] = None) -> TileConfig:
    """The one lookup every caller uses; the override merges field-wise
    over the looked-up (or builtin) config. It reads two files, so callers
    resolve once per program, never per step."""
    base = lookup(kernel, q, m, d, dtype, backend) or TileConfig()
    if override is not None:
        base = override.merged_over(base)
    return base


def record(kernel: str, cfg: TileConfig, *, q: int = 0, m: int = 0,
           d: int = 0, dtype: str = "float32",
           backend: Optional[str] = None,
           stats: Optional[dict] = None) -> str:
    """Persist a measured winner into the local cache; returns the key."""
    key = make_key(kernel, q, m, d, dtype, backend)
    entries = load_cache()
    entry = {"plan": cfg.plan, "bt": cfg.bt}
    if stats:
        entry.update(stats)
    entries[key] = entry
    save_cache(entries)
    return key


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def sweep(candidates: Sequence[TileConfig],
          bench: Callable[[TileConfig], float]
          ) -> Tuple[TileConfig, Dict[str, float]]:
    """Time every candidate (``bench`` returns seconds; it warms up and
    takes a min of repeats itself) and return the fastest."""
    if not candidates:
        raise ValueError("empty candidate list")
    timings: Dict[str, float] = {}
    best, best_t = None, float("inf")
    for cand in candidates:
        t = float(bench(cand))
        timings[f"{cand.plan}:{cand.bt}"] = t
        if t < best_t:
            best, best_t = cand, t
    return best, timings


def autotune(kernel: str, candidates: Sequence[TileConfig],
             bench: Callable[[TileConfig], float], *, q: int = 0, m: int = 0,
             d: int = 0, dtype: str = "float32",
             backend: Optional[str] = None,
             force: bool = False) -> TileConfig:
    """Sweep and persist. When the exact key is already in the *local*
    cache (a prior measurement; shipped defaults never suppress a requested
    sweep), return it without calling ``bench``."""
    key = make_key(kernel, q, m, d, dtype, backend)
    if not force:
        cached = _from_entry(load_cache().get(key))
        if cached is not None:
            CACHE_STATS["sweep_cache_hits"] += 1
            return cached
    CACHE_STATS["sweeps"] += 1
    best, timings = sweep(candidates, bench)
    record(kernel, best, q=q, m=m, d=d, dtype=dtype, backend=backend,
           stats={"us": timings[f"{best.plan}:{best.bt}"] * 1e6,
                  "swept_us": {k: v * 1e6 for k, v in timings.items()}})
    return best


def tune_engine_step(measure, base, neighbors, queries, entries, cfg,
                     options, *, reps: int = 3,
                     plans: Sequence[str] = ("rowwise", "tile"),
                     force: bool = False) -> TileConfig:
    """The engine-step plan sweep at a concrete workload shape: time a
    whole fused search per candidate plan (on the card through the
    captured programs: one warm-up search, which captures, then the least
    of ``reps`` synchronized searches) and persist the winner under the
    ``engine_step`` key of the queries' device type. ``options`` must have
    ``fused=True``; its ``tile`` is overridden per candidate. A cache hit
    at this shape skips the sweep."""
    import torch

    from repro_torch.core.corpus import as_corpus_store
    from repro_torch.core.engine import build_engine

    dev = queries.device
    store = as_corpus_store(base, options.corpus_dtype, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(cand: TileConfig) -> float:
        opts = dataclasses.replace(options, tile=f"{cand.plan}:{cand.bt}")
        eng = build_engine(measure, cfg, opts)

        def run():
            eng.search(measure.params, store, neighbors, queries, entries)
        run()
        best = float("inf")
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    return autotune(
        "engine_step", [TileConfig(plan=p, bt=8) for p in plans], bench,
        q=queries.shape[0], m=int(neighbors.shape[1]), d=int(store.dim),
        dtype=options.corpus_dtype, backend=dev.type, force=force)
