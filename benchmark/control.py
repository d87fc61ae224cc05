"""Readings behind the limits of ``benchmark/limits/<cell>.json``, at the
cell's own size, several seeds in one process:

    python3 benchmark/control.py --workload <cell> --side <side> [<side> ...] --seeds <n> [<n> ...]

Sides: ``program`` (the port as a run drives it: its set-up and the
window's first unit, which a training cell's comparison reaches into),
``control`` (the reference at float8 in the program's place: the nearest
precision below the configuration's bf16), or a fault of ``faults.py``
planted in the program; several sides run one after the other, each over
every seed. Each seed prints one JSON line of readings; with ``--out`` the
lines are appended to that file too. The benchmark's own runs never run
this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell_name: str, seed: int, side: str, device, root: Path) -> dict:
    import contextlib

    import torch

    from benchmark import common, faults
    from benchmark.harness import Context, find, load_json, load_module

    spec = load_json(root / "BENCHMARK.json")
    cell = find(spec["workloads"], cell_name, "workload")
    config = load_json(root / find(spec["configs"], cell["config"], "configuration")["file"])
    traffic = load_json(root / "benchmark" / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(root / "benchmark" / "drivers" / f"{cell['traffic']}.py",
                         f"bench_driver_{cell['traffic']}")
    ctx = Context(cell, config, traffic, seed, torch.device(device), common.Recorder())
    t0 = time.perf_counter()
    if side == "control":
        evidence = driver.reference_evidence(ctx, None, "fp8")
    else:
        plant = contextlib.nullcontext() if side == "program" else faults.plant(side)
        with plant:
            program = driver.Program(ctx)
            program.unit(0)
            evidence = program.release()
        del program
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = driver.compare(ctx, evidence, driver.reference_evidence(ctx, evidence))
    return {"cell": cell_name, "side": side, "seed": seed, "readings": out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    for side, seed in ((side, seed) for side in args.side for seed in args.seeds):
        line = json.dumps(readings(args.workload, seed, side, args.device, root))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
