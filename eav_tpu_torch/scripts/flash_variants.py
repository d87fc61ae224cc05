"""A/B timing of source variants of the flash-attention kernels on one GPU.

    python3 -m eav_tpu_torch.scripts.flash_variants [--variants committed,loop_from_tid]

Each variant is the committed ``csrc/flash_attention.cu`` with a few textual
patches (``VARIANTS``). All are built with nvcc at once, each checked against
the plain versions (bf16, every D in ``HEAD_DIMS``, T 1214, 197 and 1280 with
1214 real keys), then timed in turns at the AST shape (BH 96, T 1214, D 64,
bf16): K1, K5 and K2 + K3, a call in a run of 20 between two CUDA events,
median of 5 runs, in three rounds of alternating order, beside SDPA's forward
and aten's flash backward. Prints each variant's readings, its registers at
D 64 and ptxas's C75xx notes, then one JSON object. Needs a GPU and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import statistics
import subprocess

_LOOP = "  for (int e = threadIdx.x % WG_THREADS; e < R * CH; e += WG_THREADS) {\n"
_STAGES = "K1_STAGES = D == 128 ? 3 : 4, K5_STAGES = D == 128 ? 2 : 3;"
VARIANTS = {  # name -> ((text in the source, its replacement), ...)
    "committed": (),
    # issue_swz's copy loop counted from threadIdx.x: its start not known to be below 128
    "loop_from_tid": ((_LOOP, "  for (int e = threadIdx.x; e < R * CH; e += WG_THREADS) {\n"),),
    # issue_swz's copy loop fully unrolled, of fixed count
    "loop_unrolled": ((_LOOP, "#pragma unroll\n  for (int i = 0; i < R * CH / WG_THREADS; ++i) {\n"
                              "    const int e = i * WG_THREADS + threadIdx.x;\n"),),
    # one ring stage fewer for K1, one more for K5
    "k1_three_stages": ((_STAGES, "K1_STAGES = D == 128 ? 2 : 3, K5_STAGES = D == 128 ? 2 : 3;"),),
    "k5_four_stages": ((_STAGES, "K1_STAGES = D == 128 ? 3 : 4, K5_STAGES = D == 128 ? 3 : 4;"),),
}
B, H, T, D = 8, 12, 1214, 64


def patched(name: str) -> str:
    """The source of variant ``name``; raises if a patch does not apply once."""
    from eav_tpu_torch.ops import build

    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: patch target found {src.count(old)} times")
        src = src.replace(old, new)
    return src


def _build_all(names):
    """{name: (CDLL, ptxas report)}, the variants compiled in parallel."""
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.ops import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = patched(name)
        stem = out_dir / f"{name}-{hashlib.sha256(src.encode()).hexdigest()[:12]}"
        stem.with_suffix(".cu").write_text(src)
        procs[name] = (stem, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")),
             str(stem.with_suffix(".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (stem, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{report}")
        lib = ctypes.CDLL(str(stem.with_suffix(".so")))
        for sym, argtypes in A._SIGNATURES.items():
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def _usage(report: str) -> dict:
    """Registers of each bf16 kernel at D 64 and ptxas's C75xx notes."""
    regs, kernel = {}, None
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '\w*?\d(flash_\w+?wgmma)ILi64E", line):
            kernel = m.group(1)
        elif "Compiling entry function" in line:
            kernel = None
        elif kernel and (m := re.search(r"Used (\d+) registers", line)):
            regs[kernel] = int(m.group(1))
    notes = sorted({f"{m.group(1)} {m.group(2)}<{m.group(3)}>" for m in re.finditer(
        r"\((C75\d\d)\).*?\d(flash_\w+?wgmma)ILi(\d+)E", report)})
    return {"registers_d64": regs, "notes": notes}


def run(names=None) -> dict:
    import torch
    import torch.nn.functional as F

    from eav_tpu_torch.ops import attention as A

    names = list(names or VARIANTS)
    libs = _build_all(names)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, sym, *tensors, t_real):
        q = tensors[0]
        causal = () if sym == "eav_flash_onepass" else (0,)  # K1-K3 take the causal flag
        rc = getattr(lib, sym)(q.device.index, 1, q.shape[-1], *(t.data_ptr() for t in tensors),
                               q.shape[0], q.shape[1], t_real, q.shape[-1] ** -0.5, *causal,
                               stream)
        if rc:
            raise RuntimeError(f"{sym} failed ({rc})")

    def forward(lib, sym, q, k, v, t_real):
        o, lse = torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)
        launch(lib, sym, q, k, v, o, lse, t_real=t_real)
        return o, lse

    def inputs(bh, t, d, n, seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(bh, t, d, generator=gen, device="cuda").to(torch.bfloat16)
                for _ in range(n)]

    for name, (lib, _) in libs.items():  # every variant right before any is timed
        for d in A.HEAD_DIMS:
            for t_pad, t in ((1214, 1214), (197, 197), (1280, 1214)):
                q, k, v = inputs(12, t_pad, d, 3, d + t_pad)
                for sym, plain in (("eav_flash_fwd", A.flash_fwd_plain),
                                   ("eav_flash_onepass", A.flash_onepass_plain)):
                    o, lse = forward(lib, sym, q, k, v, t)
                    o_p, lse_p = plain(q, k, v, t)
                    torch.testing.assert_close(o.float(), o_p.float(), atol=1e-2, rtol=2e-2)
                    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-4)

    q, k, v, do = inputs(B * H, T, D, 4, 0)
    o, lse = A.flash_fwd_plain(q, k, v, T)
    di = (do.float() * o.float()).sum(-1)
    dk, dv, dq = torch.empty_like(k), torch.empty_like(v), torch.empty_like(q)

    def backward(lib):
        launch(lib, "eav_flash_dkv", q, k, v, do, lse, di, dk, dv, t_real=T)
        launch(lib, "eav_flash_dq", q, k, v, do, lse, di, dq, t_real=T)

    def run_ms(fn, calls=20, reps=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    q4, k4, v4, do4 = (x.view(B, H, T, D) for x in (q, k, v, do))
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4)

    def aten_bwd():  # (o, lse, cum_q, cum_k, max_q, max_k), dropout 0, not causal, (seed, offset)
        aten._scaled_dot_product_flash_attention_backward(do4, q4, k4, v4, *fwd[:6], 0.0, False,
                                                          *fwd[6:8])

    res = {n: {"k1_ms": [], "k5_ms": [], "k2_k3_ms": [], **_usage(libs[n][1])} for n in names}
    sdpa, lib_bwd = [], []
    for rnd in range(3):
        for name in names if rnd % 2 == 0 else names[::-1]:
            lib = libs[name][0]
            res[name]["k1_ms"].append(run_ms(lambda: forward(lib, "eav_flash_fwd", q, k, v, T)))
            res[name]["k5_ms"].append(run_ms(lambda: forward(lib, "eav_flash_onepass", q, k, v, T)))
            res[name]["k2_k3_ms"].append(run_ms(lambda: backward(lib)))
        sdpa.append(run_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)))
        lib_bwd.append(run_ms(aten_bwd))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    return {"card": card, "shape": [B * H, T, D], "sdpa_fwd_ms": sdpa, "aten_bwd_ms": lib_bwd,
            "variants": res}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    res = run(ap.parse_args(argv).variants.split(","))
    fmt = lambda xs: " / ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    print(f"{res['card']}; SDPA forward {fmt(res['sdpa_fwd_ms'])} ms, aten flash backward "
          f"{fmt(res['aten_bwd_ms'])} ms")
    for name, r in res["variants"].items():
        print(f"{name}: K1 {fmt(r['k1_ms'])}, K5 {fmt(r['k5_ms'])}, K2 + K3 {fmt(r['k2_k3_ms'])} ms; "
              f"registers at D 64 {r['registers_d64']}; notes {r['notes']}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
