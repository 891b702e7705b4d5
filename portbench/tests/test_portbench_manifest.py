"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import families, manifest  # noqa: E402
from portbench.traffic import generator  # noqa: E402

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"] for m in MAN["end_to_end"]}
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in MAN[group]]
    assert len(names) == len(set(names))
    for e in MAN[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_metric_entry_keys_and_bounds():
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_and_a_layer(cell):
    e2e = {m["name"] for m in manifest.metrics_of(MAN, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.metrics_of(MAN, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_moves_is_reported_in_each_of_its_cells(metric):
    m = next(x for x in MAN["per_layer"] if x["name"] == metric)
    assert m["moves"] in E2E
    for cell in m.get("workloads", CELLS):
        assert cell in CELLS
        names = {x["name"] for x in manifest.metrics_of(MAN, cell,
                                                         "end_to_end")}
        assert m["moves"] in names, (metric, cell)


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"]
                                    + MAN["per_layer"]])
def test_reader_found_by_name(metric):
    assert callable(manifest.reader(metric))


@pytest.mark.parametrize("cell", CELLS)
def test_config_and_traffic_found_by_name(cell):
    w = manifest.cell(MAN, cell)
    assert w["chips"] == 1
    config = manifest.config(MAN, w["config"])
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith(MAN["paths"][0] + "/")
    assert config["name"] == w["config"]
    assert entry["reduced"] == config["reduced"]
    assert set(config["limits"]) == {"score_err", "recall_at_10"}
    assert families.reference(config["measure"]).SCAN_BLOCKS
    family = config["measure"]["family"]
    assert (families.HERE / f"{family}_port.py").is_file()
    mix = generator.load(w["traffic"])
    assert mix["kind"] in ("bulk", "online")


def test_each_config_and_pair_once():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_arrivals_fill_the_window_with_the_same_gaps():
    import numpy as np
    mix = {"rate_qps": 500.0, "gap_seed": 0}
    a = generator.arrivals(mix, 4.0, np.random.default_rng(1))
    b = generator.arrivals(mix, 4.0, np.random.default_rng(2))
    assert len(a) == len(b) == 2000
    assert a[-1] == pytest.approx(4.0) and (np.diff(a) >= 0).all()
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)),
                       np.sort(np.diff(b, prepend=0.0)))
    assert not np.allclose(a, b)


def test_every_seed_serves_the_same_data_in_another_order():
    import torch
    from portbench import data as data_lib
    config = dict(manifest.config(MAN, CELLS[0].split(".")[0]),
                  n_items=500)
    a = data_lib.make_inputs(config, 64, 1, "cpu")
    b = data_lib.make_inputs(config, 64, 2**40 + 3, "cpu")
    # one corpus in one order, so every seed builds the same index
    assert torch.equal(a.corpus, b.corpus)
    assert not torch.equal(a.queries, b.queries)
    assert torch.equal(a.queries[torch.argsort(a.queries[:, 0])],
                       b.queries[torch.argsort(b.queries[:, 0])])
    again = data_lib.make_inputs(config, 64, 1, "cpu")
    assert torch.equal(a.corpus, again.corpus)
    assert torch.equal(a.queries, again.queries)


def test_every_seed_judges_the_same_users():
    import numpy as np
    from portbench import drivers
    rng = np.random.default_rng(0)
    users = rng.permutation(np.tile(np.arange(300), 3))   # 3 answers each
    picked = [users[drivers._judged(users, 50, seed)]
              for seed in (1, 2**40 + 3)]
    for p in picked:
        assert np.array_equal(np.sort(p), np.arange(50))
    a, b = (drivers._judged(users, 50, seed) for seed in (1, 2**40 + 3))
    assert not np.array_equal(a, b)


def test_online_window_holds_the_same_users_for_every_seed():
    import torch
    from portbench import data as data_lib
    config = dict(manifest.config(MAN, CELLS[0].split(".")[0]),
                  n_items=500)
    a = data_lib.make_inputs(config, 64, 1, "cpu", head=40)
    b = data_lib.make_inputs(config, 64, 2**40 + 3, "cpu", head=40)
    for x in (a, b):
        assert sorted(x.order[:40].tolist()) == list(range(40))
    assert not torch.equal(a.order, b.order)
