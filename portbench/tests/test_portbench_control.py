"""The controls (the reference in the program's place, one precision
below the configuration's) come out as not correct, and the float32
reference in the same place comes out correct; on the CPU at a small
size, and on the card (``cuda`` marker) at a larger one."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import data as data_lib  # noqa: E402
from portbench import manifest  # noqa: E402
from portbench.reference import control, judge  # noqa: E402

MAN = manifest.load()
CONFIGS = [c["name"] for c in MAN["configs"]]


def small(name: str, n_items: int, n_queries: int, device):
    config = dict(manifest.config(MAN, name), n_items=n_items)
    return config, data_lib.make_inputs(config, n_queries, 7, device)


def readings(config, inputs, mode):
    return control.run_control(config, inputs.weights, inputs.corpus,
                               inputs.queries, mode)


@pytest.mark.parametrize("name", CONFIGS)
def test_controls_fail_and_reference_passes_cpu(name):
    config, inputs = small(name, 20000, 48, "cpu")
    for mode in control.controls_for(config):
        assert readings(config, inputs, mode)["correct"] is False, mode
    ids, got = control.control_answers(config, inputs.weights,
                                       inputs.corpus, inputs.queries,
                                       "fp32")
    v = judge.judge(config, inputs.weights, inputs.corpus, inputs.queries,
                    ids, got)
    assert v["correct"] is True


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_controls_fail_on_the_card(name, card):
    config, inputs = small(name, 200000, 512, card)
    for mode in control.controls_for(config):
        assert readings(config, inputs, mode)["correct"] is False, mode
