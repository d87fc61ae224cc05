"""The benchmark's CPU tests: a tiny copy of the benchmark's tree, run on the
CPU with the port's plain kernels. Run from the repo root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_WIDTHS = {"hidden": 32, "layers": 2, "heads": 2, "mlp_dim": 64}
TINY = {
    "ast_base": {"model": {**TINY_WIDTHS, "max_frames": 128},
                 "subject": {"train": 20, "test": 12, "input": [128, 128]},
                 "protocol": {"batch_size": 8, "eval_batch_size": 8}},
    "vit_base": {"model": {**TINY_WIDTHS, "image_size": 32},
                 "subject": {"train": 20, "test": 12, "input": [32, 32, 3]},
                 "protocol": {"batch_size": 8, "eval_batch_size": 8}},
}


def tiny_tree(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's data files under
    ``dest``, its configurations cut to a tiny size (the widths, the subject,
    the batches); the code stays the repo's. Returns ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("configs", "traffic", "drivers", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, dest / "benchmark" / sub)
    for name, cut in TINY.items():
        path = dest / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        for block, values in cut.items():
            cfg[block].update(values)
        path.write_text(json.dumps(cfg, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_tree(tmp_path)
