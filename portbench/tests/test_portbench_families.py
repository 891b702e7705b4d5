"""Measure families as plug-ins found by name (``portbench/families``):

- the inputs, the reference, the counts and the kernel lists of the two
  configurations are those the harness had before the families moved
  into their own files, bit for bit (constants recorded then, at the tiny
  runs' size on the CPU);
- a new family, with its configuration, traffic file and cell, comes in
  as new files and list entries only, and runs ``correct``;
- ``kernel_roofline`` reads nothing where a stage's work ran in kernels
  the lists do not name;
- no file that dispatches on a family names one."""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import data as data_lib  # noqa: E402
from portbench import families, manifest  # noqa: E402
from portbench.reference import exact, measures  # noqa: E402
from portbench.roofline import stages  # noqa: E402
from portbench.tests.tiny_run import TINY  # noqa: E402

MAN = manifest.load()
SEED = 2**33 + 7
COUNTS = (123457.0, 65432.0, 54321.0, 47.25)   # evals, grads, iters, degree
CORPUS = "4e1959d86dea580158009f164c8db59346799e7272e16922559852afdf8fba60"
ORDER = "76fb6343bad10b76fb556db36cad8aa8fea7515f1a899ff22db807e278dc2cce"
QUERIES = "9ea51fc66e62181834c619ef68c7906048eaf5a73fc39c03896942f091815a6c"
PARENT = {
    "twitch-deepfm": {
        "weights": "81a17b1e6432a8532f557d1383567b65"
                   "7b4b920a3006564a6eb0d07462799379",
        "top10_ids": "1776991038a0b17ca7fc1201ab10d7a7"
                     "14d65d99e6d8fb19d1dfa16b48c52d28",
        "top10_logits": "05f0d5bcbbd98f34a661347d853bcfeb"
                        "49179f520711b3d5c5b8c9dc167b4e18",
        "scores": "fd2952c1d1b793438a305fbd7db159c2"
                  "41fe27e9c715c298be50a85564d0b2fe",
        "stage_work": {"measure": (2040497296.0, 21234604.0),
                       "grad": (1894910720.0, 42661664.0),
                       "rank": (616000140.0, 461416154.25)},
        "search_flops": 3935408016.0,
        "flops": (16528.0, 28960.0),
    },
    "twitch-mlp-int8": {
        "weights": "5c3ec5440decd8feb72fbd2b9e7222e2"
                   "fde62681bb2deb980d5ea006e0e7d4d8",
        "top10_ids": "659d0bbfe4a8976c7ec7ca706d212e73"
                     "fec4f1cd0a23a1b539ef97cabd45921c",
        "top10_logits": "0fe9439ba638577ed96d0fefa8e773e8"
                        "76f74a4030152828b687dad74cbc0705",
        "scores": "73a343182a4f1f06055a12f60f8f9319"
                  "5fc2f968ece36b07665fa77fe64d087c",
        "stage_work": {"measure": (2291361920.0, 6913592.0),
                       "grad": (2093824000.0, 35071552.0),
                       "rank": (616000140.0, 163682753.25)},
        "search_flops": 4385185920.0,
        "flops": (18560.0, 32000.0),
    },
}


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_inputs_reference_and_counts_are_the_parents(name):
    want = PARENT[name]
    config = dict(manifest.config(MAN, name), n_items=TINY["n_items"])
    inp = data_lib.make_inputs(config, TINY["pool"], SEED, "cpu")
    assert (sha(inp.corpus), sha(inp.order), sha(inp.queries)) == (
        CORPUS, ORDER, QUERIES)
    assert sha(*inp.weights["w"], *inp.weights["b"]) == want["weights"]
    # the judged panel: the first users of the draw
    judged = inp.queries[torch.argsort(inp.order)][:TINY["sample"]]
    with torch.no_grad():
        ids, val = exact.exact_topk(config["measure"], inp.weights,
                                    inp.corpus, judged, 10)
        got = measures.scores(config["measure"], inp.weights,
                              inp.corpus[ids], judged[:, None, :])
    assert sha(ids) == want["top10_ids"]
    assert sha(val) == want["top10_logits"]
    assert sha(got) == want["scores"]
    assert stages.stage_work(config, *COUNTS) == want["stage_work"]
    assert stages.search_flops(config, *COUNTS[:2]) == want["search_flops"]
    m = config["measure"]
    fam = families.reference(m)
    assert (fam.forward_flops(m), fam.grad_flops(m)) == want["flops"]


@pytest.mark.parametrize("hidden", [[32], [64, 64], [128, 64, 32]])
def test_mlp_counts_at_any_depth(hidden):
    m = {"family": "mlp", "d_x": 40, "d_q": 24, "hidden": hidden}
    dims = [64, *hidden, 1]
    fwd = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    back = sum(2 * a * b for a, b in zip(dims[1:-1], dims[2:])) \
        + 2 * 40 * hidden[0]
    fam = families.reference(m)
    assert fam.forward_flops(m) == fwd
    assert fam.grad_flops(m) == fwd + back
    # a gradient reads the 24-wide query, and writes and reads 40-wide rows
    config = {"dim": 40, "measure": m}
    assert fam.grad_bytes(config, 160) == 160 + 8 + 4 * 24 + 4 + 8 * 40


def kernel_run(config: dict, kernel_s: dict) -> dict:
    return {"kind": "bulk", "config": config, "mean_degree": 40.0,
            "trace": {"n_eval": 1e6, "n_grad": 1e5, "n_iters": 1e5,
                      "kernel_s": kernel_s}}


def test_kernel_roofline_reads_none_where_a_stage_matched_no_kernel():
    read = manifest.reader("kernel_roofline")
    config = manifest.config(MAN, "twitch-deepfm")
    names = {s: ps[0] for s, ps in stages.stage_kernels(config).items()}
    full = {f"void_repro::{p}<3>": 0.01 for p in names.values()}
    value = read(kernel_run(config, full))
    work = stages.stage_work(config, 1e6, 1e5, 1e5, 40.0)
    assert value == pytest.approx(100.0 * stages.least_seconds(work) / 0.03)
    for stage, pattern in names.items():
        left = {k: v for k, v in full.items() if pattern not in k}
        assert read(kernel_run(config, left)) is None, stage


def test_kernel_share_adds_the_familys_kernels(monkeypatch):
    read = manifest.reader("kernel_share")
    config = manifest.config(MAN, "twitch-deepfm")
    run = {"trace": {"busy_s": 1.0, "kernel_s": {
        "void_repro::neighbor_rank_kernel<0>": 0.25,
        "void_new_family_kernel<1>": 0.5}}, "config": config}
    assert read(run) == pytest.approx(25.0)
    fam = families.reference(config["measure"])
    monkeypatch.setattr(fam, "port_kernels", lambda: ["new_family_kernel"],
                        raising=False)
    assert read(run) == pytest.approx(75.0)


def test_no_dispatch_on_a_family_name():
    bench = ROOT / "portbench"
    files = [*bench.glob("*.py")]
    for sub in ("reference", "roofline", "metrics"):
        files += (bench / sub).glob("*.py")
    named = re.compile(r"""["'](deepfm|mlp)["']""")
    for path in files:
        hits = [n for n, line in enumerate(path.read_text().splitlines(), 1)
                if named.search(line)]
        assert not hits, (path, hits)


# a toy family: the inner product, on the port's generic stages
IP_REFERENCE = '''"""The inner product <x, q>, served as it is."""
import torch

from portbench import data as data_lib
from portbench.products import fp32_mm

SCAN_BLOCKS = (64, 1024)


def make_weights(measure, seed, device):
    return {}


def make_queries(config, n, device):
    return data_lib.normal_rows(config["data_seed"], data_lib.QUERIES, n,
                                config["measure"]["d"], device)


def logits(measure, weights, x, q, mm=fp32_mm):
    x, q = torch.broadcast_tensors(x, q)
    return mm(x[..., None, :], q[..., :, None])[..., 0, 0]


def score(logit):
    return logit


def item_terms(measure, weights, rows, mm=fp32_mm):
    return {"t": rows.T.contiguous()}


def block_logits(measure, weights, items, q, lo, hi, mm=fp32_mm):
    return mm(q, items["t"][:, lo:hi])


def forward_flops(measure):
    return 2.0 * measure["d"]


def grad_flops(measure):
    return 2.0 * measure["d"]


def eval_bytes(config, row_bytes):
    return row_bytes + 8 + 4


def grad_bytes(config, row_bytes):
    return row_bytes + 8 + 12 * config["dim"] + 4


def stage_kernels():
    return {"grad": [], "measure": []}


def port_kernels():
    return []
'''

IP_PORT = '''"""The port's inner product: the engine's generic stages."""
from repro_torch.core import inner_product_measure


def make_measure(spec, weights, device):
    return inner_product_measure()
'''


def add_toy_family(root: Path) -> str:
    """Add the inner-product family to the benchmark under ``root``: new
    files, and entries in ``BENCHMARK.json``'s lists. Returns the cell."""
    bench = root / "portbench"
    (bench / "families" / "ip.py").write_text(IP_REFERENCE)
    (bench / "families" / "ip_port.py").write_text(IP_PORT)
    config = json.loads((bench / "configs" / "twitch-deepfm.json")
                        .read_text())
    config.update(name="toy-ip", measure={"family": "ip", "d": 40},
                  limits={"score_err": 1e-3, "recall_at_10": 0.05})
    (bench / "configs" / "toy-ip.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "bulk.json").read_text())
    (bench / "traffic" / "bulk-ip.json").write_text(json.dumps(mix))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({
        "name": "toy-ip", "source": "https://arxiv.org/abs/2312.16828",
        "file": "portbench/configs/toy-ip.json", "reduced": [],
        "why": "the inner product on the generic stages"})
    cell = "toy-ip.bulk"
    man["workloads"].append({"name": cell, "config": "toy-ip",
                             "traffic": "bulk-ip", "chips": 1,
                             "why": "a toy family's bulk loop"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "twitch-deepfm.bulk" in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return cell


def test_a_new_family_comes_in_as_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    cell = add_toy_family(tmp_path)
    for rel, content in before.items():
        assert (tmp_path / rel).read_bytes() == content, rel
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "portbench" / "tests" /
                             "tiny_run.py"), cell, "1"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    result, loaded = json.loads(lines[-2]), json.loads(lines[-1])
    assert loaded == []
    assert result["correct"] is True, result["checks"]
    assert "kernel_roofline" not in result["metrics"]
    assert "search_mfu" in result["metrics"]
    assert "evals_per_query" in result["metrics"]
