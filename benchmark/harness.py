"""The benchmark's harness: one cell, one run.

Everything that belongs to one configuration, traffic mix, cell or metric is
found by its name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json`` (the file the configuration names):
  the preset, the published widths, the subject and the protocol;
- ``benchmark/families/<family>.py``, by the configuration's
  ``model.family``: what ``FAMILY`` names, the model's shapes, FLOPs,
  kernel work and plain reference;
- ``benchmark/traffic/<mix>.json``: the mix's parameters, read by
  ``benchmark/drivers/<mix>.py``, whose ``Program`` runs the program's set-up
  and its units of work, whose ``reference_evidence`` and ``compare``
  decide ``correct``, and whose ``FAULTS`` name the faults of
  ``faults.py`` that the mix's comparison has to catch;
- ``benchmark/limits/<cell>.json``: the limit of each number compared, with
  the readings it was set from;
- ``benchmark/metrics/<metric>.py``: a ``read(run)`` for each metric, which
  returns a number or None when it finds nothing to read.

A run: set-up (imports, the program's model and trainer, weights and data
made on the device from the seed, the mix's warm-up of each batch size), then whole units until
``seconds`` have passed; with ``trace`` the window's second unit runs under
the profiler (``trace.Stretch``), the window runs on until that unit is
done, and every call into the program is timed (``common.Recorder``). Once the window has closed: the device's peak memory,
the program's state freed, the reference, the comparison, the metrics, and
the last line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PROFILED_UNIT = 1  # the window's unit the traced run profiles (``trace.py``)
FORBIDDEN = ("jax", "jaxlib", "flax", "eav_tpu")  # top-level module names no run may hold
# what a family file gives (``benchmark/README.md``, "Adding to it")
FAMILY = ("param_shapes", "forward_flops", "train_flops", "kernel_work", "reference_blocks",
          "hidden", "pool", "head", "features", "logits", "hidden_module")
JSON_INF = 1e300  # a reading that is not finite, as the result line prints it


class NoCard(RuntimeError):
    """The cell asks for more cards than the machine has."""


@dataclass
class Context:
    """What a driver sees: the cell's files, the configuration's family
    module, the seed, the device, the recorder; ``mark`` times the parts of
    its set-up."""

    cell: dict
    config: dict
    traffic: dict
    family: object
    seed: int
    device: object
    rec: object
    at: float = 0.0  # the host clock at the last mark
    setup_parts: Dict[str, float] = field(default_factory=dict)

    def mark(self, part: str) -> None:
        """The seconds since the last mark, fenced, as set-up part ``part``."""
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.setup_parts[part] = now - self.at
        self.at = now


@dataclass
class Run:
    """What a metric reads."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    units: List[dict]
    spans: list = field(default_factory=list)
    events_ms: list = field(default_factory=list)
    profile: Optional[object] = None
    counters: Dict[str, int] = field(default_factory=dict)
    peaks: Optional[dict] = None
    notes: List[str] = field(default_factory=list)

    def steady_units(self) -> List[dict]:
        """The units the profiler did not slow."""
        return [u for u in self.units if not u.get("profiled")]

    def note(self, text: str) -> None:
        self.notes.append(text)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_family(root: Path, config: dict):
    """The module of the configuration's model family,
    ``benchmark/families/<family>.py``, with every name ``FAMILY`` lists."""
    name = config["model"]["family"]
    mod = load_module(root / "benchmark" / "families" / f"{name}.py", f"bench_family_{name}")
    missing = [f for f in FAMILY if not hasattr(mod, f)]
    if missing:
        raise AttributeError(f"the family {name!r} lacks {', '.join(missing)}")
    return mod


def load_cell(root: Path, name: str):
    """The cell ``name``'s files, found by name from ``BENCHMARK.json``:
    (spec, cell, config, traffic, driver module, family module)."""
    spec = load_json(root / "BENCHMARK.json")
    cell = find(spec["workloads"], name, "workload")
    config = load_json(root / find(spec["configs"], cell["config"], "configuration")["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(root / "benchmark" / "drivers" / f"{cell['traffic']}.py",
                         f"bench_driver_{cell['traffic']}")
    return spec, cell, config, traffic, driver, load_family(root, config)


def find(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        return [m for m in spec["end_to_end"] if reports(m, cell)]
    moved = {m["name"] for m in spec["end_to_end"] if reports(m, cell)}
    return [m for m in spec["per_layer"] if reports(m, cell) and m["moves"] in moved]


def program_counters() -> Dict[str, int]:
    """The port's kernel launch counters (``ops/attention.py``)."""
    from eav_tpu_torch.ops import attention

    return {fn.__name__: fn.launches for fn in attention.KERNELS}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line(device) -> str:
    """The card's name, clocks and power from ``nvidia-smi``, asked by UUID."""
    import torch

    uuid = str(torch.cuda.get_device_properties(device).uuid)
    uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not read: {e}"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, root: Path = ROOT):
    """One run of the cell ``name`` -> (the result line, the earlier info
    line), as dicts. ``device`` 'cpu' is for the tests; the command line
    refuses it."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec, cell, config, traffic, driver, family = load_cell(root, name)
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    metrics = {m["name"]: load_module(root / "benchmark" / "metrics" / f"{m['name']}.py",
                                      f"bench_metric_{m['name']}")
               for m in cell_metrics(spec, name, trace)}
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise NoCard(f"the cell asks for {cell['chips']} card(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)

    from benchmark import common, trace as tracing, yardstick

    rec = common.Recorder(trace, device)
    ctx = Context(cell, config, traffic, family, seed, device, rec, at=t_start)
    ctx.mark("imports")
    program = driver.Program(ctx)
    common.fence(device)

    units, stretch, counters = [], None, {}
    t0 = t_prev = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        i = len(units)
        rec.unit = i
        if trace and i == PROFILED_UNIT:
            before = program_counters()
            with tracing.Stretch(device) as stretch:
                info = program.unit(i)
                common.fence(device)
            after = program_counters()
            counters = {k: after[k] - before[k] for k in after}
            info["profiled"] = True
        else:
            info = program.unit(i)
            common.fence(device)
        t = time.perf_counter()
        info["seconds"] = t - t_prev
        t_prev = t
        units.append(info)
        if t - t0 >= seconds and (not trace or len(units) > PROFILED_UNIT):
            break
    window_s = t_prev - t0

    info_line = {"cell": name, "seed": seed, "seconds": seconds, "trace": int(trace),
                 "setup_s": setup_s, "setup_parts": ctx.setup_parts, "window_s": window_s,
                 "units": len(units), "unit_s": [u["seconds"] for u in units]}
    run = Run(cell, config, traffic, setup_s, window_s, units, rec.spans, rec.event_ms(),
              counters=counters)
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": cell["chips"] if on_card else 0}
    if on_card:
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
        run.peaks = yardstick.card_peaks(dev_info["kind"])
        info_line["peak_gib"] = dev_info["memory_peak_bytes"] / 2**30
        info_line["card"] = card_line(device)
    if stretch is not None:
        run.profile = stretch.read()
        dev_info["busy_s"] = run.profile.busy_s
        dev_info["window_s"] = run.profile.window_s
        info_line["counters"] = counters

    evidence = program.release()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = driver.reference_evidence(ctx, evidence)
    readings = driver.compare(ctx, evidence, ref)
    del evidence, ref
    info_line["reference_s"] = time.perf_counter() - t_ref
    info_line["readings"] = readings
    checks = {}
    for key, entry in limits["limits"].items():
        value = readings.get(key, math.inf)
        # a missing, infinite or NaN reading fails, and prints as a JSON number
        value = value if math.isfinite(value) else JSON_INF
        checks[key] = {"value": value, "limit": entry["limit"]}
    failed = sum(1 for c in checks.values() if not c["value"] <= c["limit"])

    values = {}
    for m in cell_metrics(spec, name, trace):
        v = metrics[m["name"]].read(run)
        if v is None:
            if not trace:
                raise RuntimeError(f"the end-to-end metric {m['name']} read nothing")
            continue
        values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    info_line["notes"] = run.notes

    result = {"correct": failed == 0, "attempted": sum(u["train_samples"] + u["eval_samples"]
                                                       for u in units),
              "failed": failed, "metrics": values, "device": dev_info}
    if run.profile is not None:
        result["breakdown"] = {"device_ops": run.profile.device_ops(),
                               "idle_gaps": run.profile.idle_gaps()}
    result["checks"] = checks
    return result, info_line


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")  # a library the port loads never loads Flax
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only", file=sys.stderr)
        return 3
    try:
        result, info = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                "cuda", t_start)
    except NoCard as e:
        print(str(e), file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 4
    print(json.dumps({"info": info}), flush=True)
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
