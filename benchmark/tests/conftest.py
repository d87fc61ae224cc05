"""The benchmark's CPU tests: a tiny copy of the benchmark's tree, run on the
CPU with the port's plain kernels. Run from the repo root:

    python -m pytest benchmark/tests -q -p no:cacheprovider

Each configuration's tiny cut is the file ``benchmark/tests/tiny/<config>.json``:
the blocks of the configuration (``model``, ``subject``, ``protocol``) and
the values that replace the published ones. A configuration without one
fails the tests that copy the tree; it never runs at full width here.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DIR = Path("benchmark") / "tests" / "tiny"
TINY = {p.stem: json.loads(p.read_text()) for p in sorted((ROOT / TINY_DIR).glob("*.json"))}


def cut(root: Path, name: str) -> None:
    """Cut the configuration ``name`` of the tree at ``root`` to the tiny size
    its file under ``root``'s ``benchmark/tests/tiny/`` gives."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == name)
    tiny = root / TINY_DIR / f"{name}.json"
    if not tiny.exists():
        pytest.fail(f"the configuration {name!r} has no tiny cut: add {TINY_DIR}/{name}.json "
                    "(its cells would run at their published widths on the CPU)", pytrace=False)
    path = root / entry["file"]
    cfg = json.loads(path.read_text())
    for block, values in json.loads(tiny.read_text()).items():
        cfg[block].update(values)
    path.write_text(json.dumps(cfg, indent=1))


def tiny_tree(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's folder under ``dest``,
    every configuration cut to its tiny size (``cut``); the code the runs
    import stays the repo's. Returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for c in json.loads((dest / "BENCHMARK.json").read_text())["configs"]:
        cut(dest, c["name"])
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_tree(tmp_path)
