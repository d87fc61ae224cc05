"""expert_roofline.train: the least time of the profiled epoch's expert work
over the device time of the experts' grouped GEMMs in it, as a share. The
work is the family's ``expert_gemm`` entries: each MoE layer's grouped
GEMMs at the nominal rows (k · held / E a token, even routing), forward and
backward; the kernels are those whose names hold ``KERNELS`` (the grouped
GEMM ``torch._grouped_mm`` launches on the H100, read from a trace). Notes
the pairs the port's counter saw routed over the run beside the nominal
share. None where the trace holds no such kernel."""

from benchmark import readers, yardstick

KERNELS = ("GroupProblemShape",)  # a grouped GEMM's problem shape, in its CUTLASS kernel's name
EXPERT_GEMM = "expert_gemm"  # the families' label of that work


def note_routed(run) -> None:
    """The port's tally of routed pairs (``ops/moe.routed_pairs``) over the
    run: all of them, those on the experts held here, against the nominal
    share held / E; nothing where the program has no tally."""
    try:
        from eav_tpu_torch.ops.moe import routed_pairs
    except ImportError:
        return
    model = run.config["model"]
    held = model.get("experts_held") or list(range(model["num_experts"]))
    for (device, experts), counts in routed_pairs().items():
        total = int(counts.sum())
        if experts != model["num_experts"] or total == 0:
            continue
        mine = counts[held]
        run.note(f"routed pairs on {device}: {total}, {int(mine.sum())} on the {len(held)} experts "
                 f"held ({100.0 * int(mine.sum()) / total:.2f}%, nominal "
                 f"{100.0 * len(held) / experts:.2f}%); a held expert's least and most "
                 f"{int(mine.min())} and {int(mine.max())}, any expert's "
                 f"{int(counts.min())} and {int(counts.max())}")


def read(run):
    p, unit = run.profile, readers.profiled_unit(run)
    if p is None or run.peaks is None or unit is None:
        return None
    seconds, launches = p.kernel_seconds(KERNELS)
    if launches == 0:
        return None
    work = [(flop, nbytes, calls) for k, flop, nbytes, calls in unit["work"] if k == EXPERT_GEMM]
    least = sum(calls * yardstick.least_seconds(flop, nbytes, run.peaks) for flop, nbytes, calls in work)
    run.note(f"{EXPERT_GEMM}: {launches} grouped GEMM launches in the trace, "
             f"{sum(c for *_, c in work)} MoE layer passes expected")
    note_routed(run)
    return 100.0 * least / seconds
