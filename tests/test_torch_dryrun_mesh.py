"""The dry run's production meshes (``launch/dryrun.py --mesh``) against
the JAX package's, on the CPU.

The port builds the (16, 16) and (2, 16, 16) meshes over a fake process
group of 256 and 512 ranks in this process (``dryrun.fake_mesh``) and
writes each cell's per-device report (``dryrun.run_mesh_cell``); one JAX
subprocess with 512 fake host devices builds the same jobs
(``repro.launch.steps.build_job(arch, shape, mesh, variant)``, nothing
compiled) and gives ``NamedSharding(mesh, spec).shard_shape(shape)`` of
every argument leaf under its ``in_shardings``. For each of the 42 cells
in the base variant, and the variants JAX's ``--mesh`` is run with
(``fsdp`` on the LM train cells but DeepSeek's, which both refuse,
``w8`` on the dense decode cells,
``shardnodes`` on the GIN cells, ``repltable`` on the recsys cells), on
both meshes:

- every leaf's path, global shape, dtype and shard shape equal JAX's;
- the report's per-device ``argument_bytes`` and ``alias_bytes`` are the
  sums of those shard shapes' bytes (JAX's dtypes' item sizes);
- ``n_devices`` and ``mesh_shape`` are JAX's.

The one-card ``h100`` report keeps its keys and its ``n_devices`` 1.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("torch.distributed")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
CELLS = steps.list_cells()
# DeepSeek's fsdp puts "data" twice in its expert weights' spec (EP
# override and embed): JAX refuses it (DuplicateSpecError), and so does
# the port (test_deepseek_fsdp_is_refused_as_in_jax)
LM_TRAIN = [(a, "train_4k", "fsdp") for a in
            ("yi-9b", "command-r-plus-104b", "starcoder2-3b",
             "granite-moe-3b-a800m")]
VARIANTS = (LM_TRAIN
            + [(a, s, "w8") for a in ("yi-9b", "command-r-plus-104b",
                                      "starcoder2-3b")
               for s in ("decode_32k", "long_500k")]
            + [("gin-tu", s.name, "shardnodes")
               for s in get_arch("gin-tu").shapes]
            + [(a, s.name, "repltable")
               for a in ("dlrm-rm2", "dcn-v2", "bst", "bert4rec")
               for s in get_arch(a).shapes])
JOBS = [(a, s, "base") for a, s in CELLS] + VARIANTS
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float8_e4m3fn": 1, "int32": 4,
            "int64": 8}

JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, "src")
import numpy as np
import jax
from jax.sharding import NamedSharding
from repro.ft.checkpoint import _flatten_with_paths
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_job

jobs = json.loads(sys.argv[1])
out = {}
for kind, multi in (("single", False), ("multi", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for a, s, v in jobs:
        job = build_job(a, s, mesh, variant=v)
        rows = []
        for i, (arg, sh) in enumerate(zip(job.args, job.in_shardings)):
            leaves, _ = _flatten_with_paths(arg)
            shs = jax.tree_util.tree_leaves(
                sh, is_leaf=lambda x: isinstance(x, NamedSharding))
            assert len(shs) == len(leaves), (a, s, i)
            for (k, leaf), n in zip(leaves, shs):
                path = f"{i}/{k}" if k else str(i)
                rows.append([path, list(leaf.shape),
                             list(n.shard_shape(leaf.shape)),
                             np.dtype(leaf.dtype).name])
        out[f"{kind}|{a}|{s}|{v}"] = {
            "rows": rows, "donate": list(job.donate),
            "n_devices": int(mesh.devices.size),
            "mesh_shape": {k: int(n) for k, n in mesh.shape.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_shards():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT, json.dumps(JOBS)],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def port_reports(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dryrun_mesh"))
    reps = {}
    for kind in ("single", "multi"):
        with dryrun.fake_mesh(kind) as mesh:
            for a, s, v in JOBS:
                reps[f"{kind}|{a}|{s}|{v}"] = dryrun.run_mesh_cell(
                    a, s, mesh, kind, out_dir, v)
    return reps


def _check(key, port_reports, jax_shards):
    rep, want = port_reports[key], jax_shards[key]
    # the JAX tree paths name a leaf "<arg>/<path>"; a bare-array argument
    # is "<arg>" in both
    got = [[p, shp, sh, dt] for p, shp, sh, dt in rep["shard_shapes"]]
    assert got == want["rows"], key
    nbytes = [math.prod(sh) * ITEMSIZE[dt] for _, _, sh, dt in want["rows"]]
    assert rep["memory_analysis"]["argument_bytes"] == sum(nbytes)
    alias = sum(b for (p, *_), b in zip(want["rows"], nbytes)
                if int(p.split("/")[0]) in want["donate"])
    assert rep["memory_analysis"]["alias_bytes"] == alias
    assert rep["n_devices"] == want["n_devices"]
    assert rep["mesh_shape"] == want["mesh_shape"]
    kind, _, _, variant = key.split("|")
    assert rep["mesh"] == (kind if variant == "base"
                           else f"{kind}_{variant}")


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_shard_shapes_match_jax(port_reports, jax_shards, cell):
    for kind in ("single", "multi"):
        _check(f"{kind}|{cell[0]}|{cell[1]}|base", port_reports, jax_shards)


@pytest.mark.parametrize("job", VARIANTS,
                         ids=lambda c: f"{c[0]}:{c[1]}:{c[2]}")
def test_variant_shard_shapes_match_jax(port_reports, jax_shards, job):
    for kind in ("single", "multi"):
        _check(f"{kind}|{job[0]}|{job[1]}|{job[2]}", port_reports,
               jax_shards)


def test_output_bytes_named_where_jax_names_them(port_reports):
    for key, rep in port_reports.items():
        kind = rep["static_meta"]["kind"]
        named = kind in ("prefill", "retrieval")
        assert (rep["memory_analysis"]["output_bytes"] is not None) == named
        assert ("output_bytes_note" in rep) != named
    pre = port_reports["single|yi-9b|prefill_32k|base"]
    # logits (B, V_pad) bf16 over (data, model), the cache's kv_seq on model
    assert pre["memory_analysis"]["output_bytes"] > 0


def test_deepseek_fsdp_is_refused_as_in_jax(port_reports, tmp_path):
    with dryrun.fake_mesh("single") as mesh:
        with pytest.raises(ValueError, match="used twice"):
            dryrun.run_mesh_cell("deepseek-v3-671b", "train_4k", mesh,
                                 "single", str(tmp_path), "fsdp")


def test_h100_report_is_unchanged(tmp_path):
    rep = dryrun.run_cell("gin-tu", "molecule", str(tmp_path),
                          device="meta")
    assert rep["mesh"] == "h100" and rep["n_devices"] == 1
    assert rep["mesh_shape"] == {}
    assert set(rep) == {"arch", "shape", "mesh", "n_devices", "mesh_shape",
                        "device", "build_sec", "trace_sec",
                        "memory_analysis", "cost_analysis", "op_analysis",
                        "static_meta", "fits_one_card", "card_bytes"}
    assert "shard_shapes" not in rep
