"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports ``jax``, the JAX package ``repro`` or ``ml_dtypes`` (a dependency
of JAX, not of the port), and its default device is the card, never a
silent CPU fallback."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_BLOCKED_IMPORTS = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "ml_dtypes"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    # the end-to-end example imports the port alone
    spec = importlib.util.spec_from_file_location(
        "serve_ranking_torch", "examples/serve_ranking_torch.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    # the index files' bf16 and int8 payloads go through torch alone
    import tempfile, numpy as np
    from repro_torch.graph import (GraphIndex, load_corpus_store,
                                   load_index, save_index)
    base = np.random.default_rng(0).normal(size=(40, 8)).astype(np.float32)
    g = GraphIndex(np.zeros((40, 4), np.int32), 0, base)
    for dt in ("bfloat16", "int8"):
        with tempfile.TemporaryDirectory() as d:
            save_index(d, g, corpus_dtype=dt)
            assert load_corpus_store(d, device="cpu").dtype == dt
            assert np.abs(load_index(d).base - base).max() < 0.05
            # paged residency over the memory-mapped files, and a mutation
            paged = load_corpus_store(d, residency="paged", device="cpu")
            assert paged.is_paged and paged.take(np.arange(40)).shape == (
                40, 8)
    from repro_torch.graph import DurableIndex, build_l2_graph
    with tempfile.TemporaryDirectory() as d:
        di = DurableIndex.create(d, build_l2_graph(base, m=4,
                                                   k_construction=8,
                                                   device="cpu"),
                                 device="cpu")
        di.insert(base[:3] + 1.0, k_candidates=8)
        assert DurableIndex.open(d, device="cpu").index.n == 43
    # the tuning cache and the legacy searcher run without JAX too
    import os, torch
    from repro_torch.kernels import autotune
    from repro_torch.core import (SearchConfig, make_family_measure,
                                  search_legacy)
    assert autotune.parse_tile("tile:4").bt == 4
    assert autotune.shipped_defaults()
    with tempfile.TemporaryDirectory() as d:
        os.environ["REPRO_TORCH_TUNING_CACHE"] = os.path.join(d, "c.json")
        autotune.record("engine_step", autotune.TileConfig("tile", 8),
                        backend="cpu")
        assert autotune.resolve("engine_step", backend="cpu").plan == "tile"
    g = build_l2_graph(base, m=4, k_construction=8, device="cpu")
    m = make_family_measure("deepfm", torch.Generator().manual_seed(0), 8,
                            device="cpu")
    r = search_legacy(m.score_fn, m.params, base, g.neighbors,
                      torch.as_tensor(base[:3]), torch.full((3,), g.entry),
                      SearchConfig(k=3, ef=8, budget=4))
    assert r.ids.shape == (3, 3)
    # the LM and GNN families: prefill and decode through the attention
    # kernels' plain versions, DeepSeek-V3, GIN on a sampled batch,
    # compression
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.data import NeighborSampler, make_graph
    from repro_torch.models import gnn, transformer
    from repro_torch.train import compress
    for name in ("yi-9b", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(get_arch(name).make_smoke_config(),
                                  dtype=torch.float32)
        p, _ = transformer.init_params(torch.Generator().manual_seed(0), cfg,
                                       device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 8),
                             generator=torch.Generator().manual_seed(1))
        lg, cache = transformer.prefill(p, toks, cfg)
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 2))
                 for k, v in cache.items()}
        lg, _ = transformer.decode_step(p, cache, toks[:, -1], 8, cfg)
        assert torch.isfinite(lg).all()
    # DeepSeek-V3: MLA prefill, the absorbed decode, the loss with MTP
    from repro_torch.models import deepseek
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").make_smoke_config(),
                              dtype=torch.float32)
    p, _ = deepseek.init_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    lg, cache = deepseek.prefill(p, toks, cfg)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 2))
             for k, v in cache.items()}
    lg, _ = deepseek.decode_step(p, cache, toks[:, -1], 8, cfg)
    assert torch.isfinite(lg).all()
    assert torch.isfinite(deepseek.lm_loss(p, toks, toks, cfg))
    gcfg = get_arch("gin-tu").make_smoke_config()
    gp, _ = gnn.init_params(torch.Generator().manual_seed(0), gcfg,
                            device="cpu")
    g = make_graph(200, 800, gcfg.d_in, n_classes=gcfg.n_classes)
    b = NeighborSampler(g["src"], g["dst"], 200, (4, 3)).sample(
        np.arange(8), g["feats"], g["labels"], 64, 64)
    out = gnn.forward(gp, torch.from_numpy(b.feats), torch.from_numpy(b.src),
                      torch.from_numpy(b.dst), gcfg,
                      edge_mask=torch.from_numpy(b.edge_mask))
    assert out.shape == (64, gcfg.n_classes)
    q, s = compress.quantize_int8(out.detach())
    assert q.dtype == torch.int8
    # the launch layer: a cell built and counted on meta, the dry run's
    # trace, the guitar-serve cell drawn and searched on the CPU
    from repro_torch.core import make_sharded_search  # noqa: F401
    from repro_torch.launch import dryrun, op_analysis, steps
    job = steps.build_job("dlrm-rm2", "serve_p99")
    assert op_analysis.analyze_ops(job.step_fn, *job.args).flops > 0
    assert dryrun.trace(steps.build_job("gin-tu", "molecule"))[0].flops > 0
    gjob = steps.build_guitar_serve_job("guitar", n_items=300, n_queries=4)
    assert gjob.step_fn(*steps.materialize(gjob, "cpu")).ids.shape == (4, 10)
    assert not any(k.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                   for k in sys.modules), "a blocked module got in"
    print(len(names))
""")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT)])
    return env


def test_port_imports_no_jax_and_no_repro():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                         capture_output=True, text=True, env=_env(),
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_port_sources_name_no_jax():
    files = sorted(SRC.glob("repro_torch/**/*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "examples" / "serve_ranking_torch.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import repro.", "from repro.",
                                     "from repro import",
                                     "import ml_dtypes",
                                     "from ml_dtypes")), (f, s)


def test_serve_default_device_refuses_cpu_fallback():
    """Without --device cpu the launcher needs a card; here it has none,
    so it must fail instead of serving on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--items", "300",
         "--queries", "8"], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "cuda" in (out.stdout + out.stderr).lower()
    assert "QPS" not in out.stdout


def test_train_default_device_is_the_card():
    """The training launcher's --device defaults to the card; without one
    it fails instead of training on the CPU."""
    from repro_torch.launch import train
    assert train.build_parser().get_default("device") == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "bst",
         "--steps", "2"], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert "[train] bst" not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py in a directory without the rest of the repository
    exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
