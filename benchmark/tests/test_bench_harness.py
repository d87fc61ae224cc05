"""The harness on the CPU: cells, mixes and metrics found by name from files
alone, every cell's run at a tiny size, the contract's shape of
BENCHMARK.json, the refusal without a card, and the trace's reduction."""

import json
import math
import re
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

from benchmark import readers, trace, yardstick
from benchmark.harness import Run, cell_metrics, forbidden_modules, load_json, run_cell

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in SPEC["workloads"]]
SEED = 2**31 + 17  # a seed past 32 signed bits, as the driver's are
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).exists()
        assert load_json(ROOT / c["file"])["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for cell in CELLS:
        assert "setup_s" in [m["name"] for m in cell_metrics(SPEC, cell, False)]
        assert len(cell_metrics(SPEC, cell, False)) >= 2 and cell_metrics(SPEC, cell, True)
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = next(w for w in SPEC["workloads"] if w["name"] == cell)
    bench = ROOT / "benchmark"
    config = next(e for e in SPEC["configs"] if e["name"] == c["config"])
    family = load_json(ROOT / config["file"])["model"]["family"]
    for path in (bench / "traffic" / f"{c['traffic']}.json",
                 bench / "drivers" / f"{c['traffic']}.py",
                 bench / "limits" / f"{cell}.json",
                 bench / "families" / f"{family}.py",
                 bench / "tests" / "tiny" / f"{c['config']}.json"):
        assert path.exists(), path
    for m in cell_metrics(SPEC, cell, False) + cell_metrics(SPEC, cell, True):
        assert (bench / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_at_a_tiny_size(tiny_root, cell, trace_on):
    result, info = run_cell(cell, SEED, 0.3, bool(trace_on), "cpu", root=tiny_root)
    assert result["correct"] is True and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert result["attempted"] > 0 and info["units"] >= 1 + trace_on
    e2e = {m["name"] for m in cell_metrics(SPEC, cell, False)}
    if not trace_on:
        assert set(result["metrics"]) == e2e
        assert all(v["value"] > 0 for v in result["metrics"].values())
    else:
        # off the card only the host-clock readers find something to read
        assert set(result["metrics"]) <= {m["name"] for m in cell_metrics(SPEC, cell, True)}
        assert "breakdown" in result and set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["busy_s"] == 0.0


def test_a_new_cell_mix_and_metric_need_only_files(tiny_root):
    """A throwaway configuration, cell and per-layer metric, added as files
    and entries in a copy: the harness runs them unedited."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny_root / "benchmark/configs/ast_base.json").read_text())
    cfg["name"] = "ast_small"
    cfg["model"]["layers"] = 1
    (tiny_root / "benchmark/configs/ast_small.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "ast_small", "source": "https://example.org/ast-small",
                            "file": "benchmark/configs/ast_small.json", "reduced": ["layers"],
                            "why": "a throwaway configuration"})
    mix = json.loads((tiny_root / "benchmark/traffic/features_pass.json").read_text())
    mix["name"] = "features_twice"
    (tiny_root / "benchmark/traffic/features_twice.json").write_text(json.dumps(mix))
    (tiny_root / "benchmark/drivers/features_twice.py").write_text(
        (tiny_root / "benchmark/drivers/features_pass.py").read_text())
    spec["workloads"].append({"name": "ast_small.twice", "config": "ast_small",
                              "traffic": "features_twice", "chips": 1, "why": "throwaway"})
    (tiny_root / "benchmark/limits/ast_small.twice.json").write_text(
        (tiny_root / "benchmark/limits/ast_base.features.json").read_text())
    for e in spec["end_to_end"]:
        if e["name"] == "extract_samples_per_s":
            e["workloads"].append("ast_small.twice")
    spec["per_layer"].append({"name": "units_in_window.extract", "unit": "units",
                              "better": "higher", "source": "host_clock", "layer": "harness",
                              "moves": "extract_samples_per_s", "workloads": ["ast_small.twice"]})
    (tiny_root / "benchmark/metrics/units_in_window.extract.py").write_text(
        "def read(run):\n    return len(run.units)\n")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, info = run_cell("ast_small.twice", SEED, 0.2, True, "cpu", root=tiny_root)
    assert result["correct"] and result["metrics"]["units_in_window.extract"]["value"] == info["units"]
    result, _ = run_cell("ast_small.twice", SEED, 0.2, False, "cpu", root=tiny_root)
    assert set(result["metrics"]) == {"extract_samples_per_s", "setup_s"}


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints nothing on
    standard output; so it does in a directory holding only the benchmark."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for where in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                               "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                              cwd=where, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and proc.stdout == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "eav_tpu.core", object())
    assert forbidden_modules() == ["eav_tpu"]


def _event(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_trace_reduction_on_a_written_trace():
    events = [
        _event("user_annotation", trace.ANNOTATION, 0, 100),
        _event("cpu_op", "aten::mm", 5, 20), _event("cuda_runtime", "cudaLaunchKernel", 10, 3),
        _event("cpu_op", "aten::item", 60, 35),
        _event("cpu_op", "other-thread op", 30, 10, tid=2),
        _event("kernel", "void flash_fwd_wgmma<64>(x)", 20, 10, tid=7),
        _event("kernel", "gemm", 25, 15, tid=8),  # overlaps the first: busy 20..40
        _event("gpu_memcpy", "Memcpy DtoH", 70, 10, tid=7),
        _event("kernel", "late", 95, 20, tid=7),  # clipped at the span's end
    ]
    p = trace.Profile(events)
    assert p.window_s == pytest.approx(100e-6)
    assert p.busy_s == pytest.approx((20 + 10 + 5) * 1e-6)
    assert p.kernel_seconds(("flash_fwd",)) == (pytest.approx(10e-6), 1)
    # gaps 0-20 (mid 10: the launch), 40-70 (mid 55: no op, the annotation),
    # 80-95 (mid 87.5: aten::item)
    gaps = dict(p.idle_gaps())
    assert gaps == {"cudaLaunchKernel": pytest.approx(20e-6), trace.ANNOTATION: pytest.approx(30e-6),
                    "aten::item": pytest.approx(15e-6)}
    assert p.device_ops()[0] == ["gemm", pytest.approx(15e-6)]


def _run(units, profile=None, peaks=None, counters=None):
    return Run({}, {}, {}, 1.0, sum(u["seconds"] for u in units), units, profile=profile,
               peaks=peaks, counters=counters or {})


def test_readers_read_nothing_rather_than_zero():
    unit = {"train_samples": 8, "eval_samples": 4, "flops": 1e12, "seconds": 2.0,
            "work": [("flash_fwd", *yardstick.attention_work("fwd", 96, 1214, 64), 12)]}
    run = _run([dict(unit), dict(unit, profiled=True)])
    assert readers.mfu(run, True) is None  # no card, no peak
    assert readers.roofline(run, ("flash_fwd",)) is None
    assert readers.idle_pct(run, True) is None
    assert readers.per_second(run, train=False) is None  # a training window
    assert readers.per_second(run, train=True) == pytest.approx(16 / 4.0)


def test_flash_roofline_counts_work_from_shapes():
    """The least time of the unit's work entries, as the family counts them
    from the model's shapes, over the kernels' time in the trace; entries
    of other kernels do not count."""
    events = [_event("user_annotation", trace.ANNOTATION, 0, 1000),
              _event("kernel", "flash_fwd_wgmma<64>", 0, 100, tid=7)]
    unit = {"train_samples": 0, "eval_samples": 1, "flops": 0.0, "seconds": 1.0,
            "work": [("flash_fwd", *yardstick.attention_work("fwd", 96, 1214, 64), 2),
                     ("flash_dq", *yardstick.attention_work("dq", 96, 1214, 64), 2)],
            "profiled": True}
    peaks = {"bfloat16": 989e12, "bytes": 3.35e12}
    run = _run([dict(unit, profiled=False), unit], trace.Profile(events), peaks,
               {"flash_fwd": 2})
    flop, nbytes = 4 * 1214**2 * 64 * 96, 4 * 96 * 1214 * 64 * 2 + 96 * 1214 * 4
    least = 2 * max(flop / 989e12, nbytes / 3.35e12)
    assert readers.roofline(run, ("flash_fwd",)) == pytest.approx(100 * least / 100e-6)
    assert run.notes == ["flash_fwd: 2 launches counted, 2 calls expected"]
    assert readers.idle_pct(run, False) == pytest.approx(100 * (1 - 100e-6 / 1.0))
    assert math.isfinite(readers.p95([1.0, 2.0, 3.0])) and readers.p95([]) is None
