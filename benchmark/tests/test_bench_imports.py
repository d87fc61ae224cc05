"""A run imports neither JAX nor the JAX package; the reference imports
nothing of the port. Top-level module names are compared whole
(``eav_tpu_torch`` is not ``eav_tpu``). Each check runs in a fresh process."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "eav_tpu"}
RUN = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{root!r}, {tests!r}]
import torch
torch.set_num_threads(2)
from conftest import tiny_tree
from benchmark.harness import run_cell
root = tiny_tree(Path(tempfile.mkdtemp()))
result, _ = run_cell({cell!r}, 2**31 + 3, 0.2, True, "cpu", root=root)
assert result["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(code):
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["ast_base.unfrozen", "vit_base.features"])
def test_a_run_loads_no_jax(cell):
    names = top_level(RUN.format(root=str(ROOT), tests=str(ROOT / "benchmark/tests"), cell=cell))
    assert "eav_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    """Nor do the family files and what they stand on."""
    names = top_level(f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); "
                      "import benchmark.reference.transformer, benchmark.yardstick; "
                      "from pathlib import Path; from benchmark.harness import load_module; "
                      f"[load_module(p, p.stem) for p in Path({str(ROOT)!r}).glob("
                      "'benchmark/families/*.py')]; "
                      "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "benchmark" in names and not names & (FORBIDDEN | {"eav_tpu_torch"})
