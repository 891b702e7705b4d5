"""The port's one-card dry run (``python -m repro_torch.launch.dryrun``):
cheap cells at their own configs traced on meta (one in a subprocess, two
through the launcher's ``main`` in this process), each report with the JAX dry run's keys where they mean something on one card
(``trace_sec`` for ``lower_sec``, ``op_analysis`` for ``hlo_analysis``),
the default ``--device cuda`` refusing to run without a card, and the
depth cut's counts scaled exactly to the full depth."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch.hlo_analysis import HLOReport  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(SRC), str(ROOT)])
    return env


def _jax_report_keys():
    """The keys of the report dict in the JAX package's ``run_cell`` and
    of its ``memory_analysis``, read from the source (running it needs 256
    devices)."""
    tree = ast.parse((SRC / "repro" / "launch" / "dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "report" for t in node.targets):
            keys = {k.value: v for k, v in zip(node.value.keys,
                                               node.value.values)}
            return set(keys), {k.value for k in keys["memory_analysis"].keys}
    raise AssertionError("no report dict in the JAX dry run")


def _check_report(tmp_path, arch, shape):
    rep = json.loads((tmp_path / "h100" / f"{arch}__{shape}.json")
                     .read_text())
    top, mem = _jax_report_keys()
    # JAX's lowering and compile times and its HLO parse have no meaning
    # here: trace_sec and the op counter take their place
    assert top - {"lower_sec", "compile_sec", "hlo_analysis"} <= set(rep)
    assert {"trace_sec", "op_analysis", "fits_one_card"} <= set(rep)
    assert set(rep["memory_analysis"]) == mem
    assert set(rep["op_analysis"]) == set(HLOReport(
        0, 0, 0, {}, 0, {}).to_dict())
    assert rep["n_devices"] == 1 and rep["mesh_shape"] == {}
    assert rep["memory_analysis"]["temp_bytes"] is None
    assert rep["op_analysis"]["total_collective_bytes"] == 0.0
    assert rep["op_analysis"]["flops"] > 0
    assert rep["cost_analysis"]["flops_body_once"] == \
        rep["op_analysis"]["flops"]
    job = steps.build_job(arch, shape)
    assert rep["static_meta"] == job.static_meta
    assert rep["memory_analysis"]["argument_bytes"] == \
        dryrun.tree_nbytes(job.args)
    assert rep["fits_one_card"] is True
    ops = json.loads((tmp_path / "h100" / f"{arch}__{shape}.ops.json")
                     .read_text())
    assert sum(ops["flops_by_op"].values()) == rep["op_analysis"]["flops"]


def _args(arch, shape, out):
    return ["--arch", arch, "--shape", shape, "--device", "meta", "--out",
            str(out), "--save-hlo"]


def test_dryrun_meta_in_a_subprocess(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun",
         *_args("gin-tu", "molecule", tmp_path)],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "all 1 cells traced OK" in out.stdout
    _check_report(tmp_path, "gin-tu", "molecule")


@pytest.mark.parametrize("cell", [("bst", "serve_p99"),
                                  ("dlrm-rm2", "serve_p99")],
                         ids=lambda c: f"{c[0]}:{c[1]}")
def test_dryrun_meta_writes_reports_with_jax_keys(tmp_path, capsys, cell):
    """The launcher's ``main`` on the argv the subprocess test passes (in
    this process: a subprocess pays the import of torch each time)."""
    dryrun.main(_args(*cell, tmp_path))
    assert "all 1 cells traced OK" in capsys.readouterr().out
    _check_report(tmp_path, *cell)


def test_dryrun_default_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gin-tu", "--shape", "molecule", "--out", str(tmp_path)],
        capture_output=True, text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr or "cuda" in out.stderr.lower()
    assert not (tmp_path / "h100").exists()


def test_depth_cut_scales_exactly():
    """Traced at 2 and 3 layers, the counts of a 6-layer stack (the smoke
    widths) are the 6-layer trace's: every layer dispatches the same
    products and the same bytes."""
    arch = get_arch("yi-9b")

    def build(n):
        cfg = dataclasses.replace(arch.make_smoke_config(), n_layers=n)
        return steps.build_lm_job(
            dataclasses.replace(arch, make_config=lambda: cfg),
            ShapeSpec("d", "decode", {"seq": 64, "batch": 2}))

    scaled, _, _, note = dryrun.trace_scaled(build, 6, 2)
    full = dryrun.trace(build(6))[0].to_dict()
    for key in ("flops", "bytes_accessed", "bytes_bf16eq"):
        assert scaled[key] == full[key], key
    assert note["traced_layers"] == [2, 3] and note["full_layers"] == 6
