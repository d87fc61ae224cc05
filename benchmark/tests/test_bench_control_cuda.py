"""On the card, at each cell's own size: the control (the reference at
float8 in the program's place) fails the cell's limits, and the port passes
them. Skips without a CUDA card; run it on the card with

    python -m pytest benchmark/tests/test_bench_control_cuda.py -q -p no:cacheprovider
"""

import pytest
import torch

from benchmark.control import readings
from benchmark.harness import load_json

from conftest import ROOT

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in SPEC["workloads"]]


def limits(cell):
    return {k: v["limit"] for k, v in load_json(ROOT / f"benchmark/limits/{cell}.json")["limits"].items()}


def passes(cell, side, seed):
    got = readings(cell, seed, side, "cuda", ROOT)["readings"]
    return all(got[k] <= lim for k, lim in limits(cell).items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_the_port_passes_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the comparison runs at the cell's own size")
    ok, got = passes(cell, "control", 2**31 + 101)
    assert not ok, got
    ok, got = passes(cell, "program", 2**31 + 101)
    assert ok, got


@pytest.mark.cuda
def test_a_backward_of_the_wrong_direction_fails_on_the_card():
    """K2's dK negated (``faults.dk_negated``): a gradient of the right size
    and the wrong direction, which only the change's direction catches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernels' backward runs only there")
    cell = "ast_base.unfrozen"
    ok, got = passes(cell, "dk_negated", 2**31 + 103)
    assert not ok and got["change_dir_gap"] > limits(cell)["change_dir_gap"], got
