#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``eav_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run on error:

1. the card: name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build: the package's CUDA source with nvcc, and each tensor-core
   kernel's registers and spill bytes from ptxas's report;
3. kernels: each flash-attention kernel (K1 forward, K2 dK/dV, K3 dQ, K5
   one-pass forward) against its plain PyTorch version at the AST shape
   (B 8, H 12, D 64, T 1214), at T 197 and padded (T 1280 with 1214 real
   keys), in bfloat16 and float32, K1-K3 also through the autograd function,
   and a planted fault (one key short in the mask) that the same checks must
   reject; times of kernel, plain version and the library's attention
   forward and backward (yardsticks only: the port never calls them), each
   kernel and library call timed twice: one call between two CUDA events
   (``ms``, host work before the launch included) and a run of 20
   back-to-back calls (``ms_run``, the device's time a call);
4. model and frontend: full-width AST-base with flash attention against math
   attention on the same weights, resampling and fbank on the card against
   the CPU;
5. main path: ``ModalityPipelines.run_audio`` on a synthetic EAV subject with
   the full-width ``ast_finetune`` preset (AST-base, bf16), one frozen and one
   unfrozen epoch; the launch counts of K1, K2 and K3 must rise;
6. train step: median time of the unfrozen AST-base train step at batch 8,
   and a torch.profiler breakdown of its device time by kernel;
7. the one-pass experiment (``eav_tpu_torch.scripts.flash_onepass_experiment``)
   at the AST shape: streaming (K1) and one-pass (K5) forward times, their
   max |err| (within the bf16 tolerance), GELU erf and tanh; the launch
   counts of K5 and K1 must rise;
8. vision path: ``ModalityPipelines.run_vision`` with the full-width
   ``vit_finetune`` preset (ViT-base, 224x224, bf16), one frozen and one
   unfrozen epoch, on a synthetic subject's uint8 frame cache (the script
   needs no video decoder: cv2 decodes on the CPU side, tested there);
   finite losses, the metrics keys, trial-voted archives;
9. the unfrozen ViT-base train step at batch 128 (uint8 56x56 frames,
   resized in the model), median time of 10 with the preset's math attention
   and its profile, then the same step through the flash kernels.

Float32 checks run with TF32 off for both matmuls and cuDNN convolutions, so
float32 means float32 throughout the run. The last lines are the ``kernels``
JSON, the ``nvidia-smi`` line and ``{"ok": true, "device": {...}}``. Exits
non-zero without that line when there is no GPU or a phase fails.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# (atol, rtol) of each kernel against its plain version. bfloat16 outputs
# (O, dQ, dK, dV, typically ~0.05 in size here) differ by an ulp or two where
# the sum order differs, so 1e-2 / 2e-2 holds them while a key dropped from
# the mask still fails; LSE is float32 from the same bf16 products.
TOLERANCE = {
    "bfloat16": {"out": (1e-2, 2e-2), "lse": (1e-4, 1e-4)},
    "float32": {"out": (2e-4, 2e-4), "lse": (2e-4, 2e-4)},
}
B, H, D = 8, 12, 64
T_AST = 1214


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_run(fn, calls: int = 20, reps: int = 5, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn`` over a run of ``calls`` back-to-back
    calls between two CUDA events, median of ``reps`` runs: the launches
    queue ahead of the device, so the host's work before each launch hides
    behind the previous call and the reading is the device's."""
    import torch

    for _ in range(warmup):
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


def max_err(got, want, atol: float, rtol: float) -> float:
    """Max |got - want|; raises if any element is outside atol + rtol |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= atol + rtol * want.abs()).all()):
        raise AssertionError(
            f"max abs err {float(err.max()):.3g} beyond atol {atol}, rtol {rtol}")
    return float(err.max())


def must_reject(got, want, atol: float, rtol: float, what: str) -> None:
    """Raises unless ``max_err`` rejects ``got`` against ``want``."""
    try:
        max_err(got, want, atol, rtol)
    except AssertionError:
        return
    raise AssertionError(f"the check passed a planted fault: {what}")


# -----------------------------------------------------------------------------
# 1. the card
# -----------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# -----------------------------------------------------------------------------
# 3. kernels against their plain versions
# -----------------------------------------------------------------------------


def kernel_inputs(t: int, dtype, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(B * H, t, D, generator=gen, device="cuda").to(dtype) for _ in range(4)
    ]


def check_kernels(t_pad: int, t: int, dtype_name: str, seed: int) -> dict:
    """Each kernel and the autograd path against the plain versions on the
    same (BH, t_pad, D) inputs with ``t`` real keys, then a planted fault:
    the plain versions with the last real key masked must fail the same
    checks. Returns the max abs errors by kernel."""
    import torch

    from eav_tpu_torch.ops import attention as A

    dtype = getattr(torch, dtype_name)
    tol, tol_lse = TOLERANCE[dtype_name]["out"], TOLERANCE[dtype_name]["lse"]
    q, k, v, do = kernel_inputs(t_pad, dtype, seed)
    o_p, lse_p = A.flash_fwd_plain(q, k, v, t)
    o, lse = A.flash_fwd(q, k, v, t)
    torch.cuda.synchronize()
    errs = {"flash_fwd": max(max_err(o, o_p, *tol), max_err(lse, lse_p, *tol_lse))}
    di = (do.float() * o_p.float()).sum(-1)
    dk_p, dv_p = A.flash_dkv_plain(q, k, v, do, lse_p, di, t)
    dq_p = A.flash_dq_plain(q, k, v, do, lse_p, di, t)
    dk, dv = A.flash_dkv(q, k, v, do, lse_p, di, t)
    dq = A.flash_dq(q, k, v, do, lse_p, di, t)
    torch.cuda.synchronize()
    errs["flash_dkv"] = max(max_err(dk, dk_p, *tol), max_err(dv, dv_p, *tol))
    errs["flash_dq"] = max_err(dq, dq_p, *tol)
    # the autograd function: K1 forward, rowsum(dO*O), K2 and K3 backward
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = A.FlashAttention.apply(*leaves, t)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    for g, want in zip(grads, (dq_p, dk_p, dv_p)):
        max_err(g, want, *tol)
    # K5, the one-pass forward, against its own plain version
    o1_p, lse1_p = A.flash_onepass_plain(q, k, v, t)
    o1, lse1 = A.flash_onepass(q, k, v, t)
    torch.cuda.synchronize()
    errs["flash_onepass"] = max(max_err(o1, o1_p, *tol), max_err(lse1, lse1_p, *tol_lse))
    # planted fault: a mask one key short must fail every check above
    o_f, lse_f = A.flash_fwd_plain(q, k, v, t - 1)
    dk_f, dv_f = A.flash_dkv_plain(q, k, v, do, lse_p, di, t - 1)
    dq_f = A.flash_dq_plain(q, k, v, do, lse_p, di, t - 1)
    o1_f, lse1_f = A.flash_onepass_plain(q, k, v, t - 1)
    for got, want, tl, what in ((o, o_f, tol, "O"), (lse, lse_f, tol_lse, "LSE"),
                                (dk, dk_f, tol, "dK"), (dv, dv_f, tol, "dV"),
                                (dq, dq_f, tol, "dQ"), (o1, o1_f, tol, "K5 O"),
                                (lse1, lse1_f, tol_lse, "K5 LSE")):
        must_reject(got, want, *tl, f"{what} against a mask at t_real={t - 1}")
    log(f"kernels T={t_pad} (t_real {t}) {dtype_name}: max abs err "
        + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + f" (atol, rtol {tol}; LSE {tol_lse}); autograd ok; a mask at t_real={t - 1} "
        "fails O, LSE, dK, dV, dQ and K5's O and LSE")
    return errs


def time_kernels(seed: int) -> dict:
    """Times at the main path's shape and type (bf16, T 1214): kernel (one
    call, and a call in a run of 20), plain version, and the library call
    that computes the same function (one call, and in a run of 20)."""
    import torch
    import torch.nn.functional as F

    from eav_tpu_torch.ops import attention as A

    t = T_AST
    q, k, v, do = kernel_inputs(t, torch.bfloat16, seed)
    o, lse = A.flash_fwd(q, k, v, t)
    di = (do.float() * o.float()).sum(-1)
    calls = {  # name -> (kernel, plain version)
        "flash_fwd": (lambda: A.flash_fwd(q, k, v, t), lambda: A.flash_fwd_plain(q, k, v, t)),
        "flash_dkv": (lambda: A.flash_dkv(q, k, v, do, lse, di, t),
                      lambda: A.flash_dkv_plain(q, k, v, do, lse, di, t)),
        "flash_dq": (lambda: A.flash_dq(q, k, v, do, lse, di, t),
                     lambda: A.flash_dq_plain(q, k, v, do, lse, di, t)),
        "flash_onepass": (lambda: A.flash_onepass(q, k, v, t),
                          lambda: A.flash_onepass_plain(q, k, v, t)),
    }
    times = {n: (cuda_ms(fn), cuda_ms_run(fn), cuda_ms(plain))
             for n, (fn, plain) in calls.items()}
    # SDPA on the same values in its (B, H, T, D) layout
    q4, k4, v4, do4 = (x.view(B, H, t, D) for x in (q, k, v, do))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4)

    sdpa_fwd = (cuda_ms(sdpa), cuda_ms_run(sdpa))
    leaves = [x.detach().clone().requires_grad_(True) for x in (q4, k4, v4)]

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(*leaves), leaves, do4)

    flat = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]

    def flash_fwd_bwd():
        torch.autograd.grad(A.FlashAttention.apply(*flat, t), flat, do)

    fb_sdpa, fb_flash = cuda_ms(sdpa_fwd_bwd), cuda_ms(flash_fwd_bwd)
    # aten's flash-attention backward: one call for dQ, dK and dV together
    # (and its own rowsum(dO*O)), the yardstick of K2 + K3 together
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4)
    o4, lse4, cum_q, cum_k, max_q, max_k, seed_t, offset_t = fwd[:8]

    def aten_bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, o4, lse4, cum_q, cum_k, max_q, max_k, 0.0, False,
            seed_t, offset_t)

    lib_bwd = (cuda_ms(aten_bwd), cuda_ms_run(aten_bwd))
    dq4, dk4, dv4 = aten_bwd()
    dk, dv = A.flash_dkv(q, k, v, do, lse, di, t)
    diff = max(float((a.float().reshape(b.shape) - b.float()).abs().max())
               for a, b in ((dq4, A.flash_dq(q, k, v, do, lse, di, t)), (dk4, dk), (dv4, dv)))
    log(f"fwd+bwd T={t} bf16: flash {fb_flash:.3f} ms, scaled_dot_product_attention "
        f"{fb_sdpa:.3f} ms; backward (one call / in a run of 20): K2 + K3 "
        f"{times['flash_dkv'][0] + times['flash_dq'][0]:.3f} / "
        f"{times['flash_dkv'][1] + times['flash_dq'][1]:.3f} ms, aten flash backward "
        f"{lib_bwd[0]:.3f} / {lib_bwd[1]:.3f} ms (max abs diff of its dQ, dK, dV from "
        f"K2/K3: {diff:.3g})")
    # the backward's library time stands on both K2 and K3: one call covers both
    library = {"flash_fwd": sdpa_fwd, "flash_dkv": lib_bwd, "flash_dq": lib_bwd,
               "flash_onepass": sdpa_fwd}
    return {n: (*ms, *library[n]) for n, ms in times.items()}


def kernel_bounds(t: int) -> dict:
    """Least time (ms) and what bounds it, for each kernel at (B*H, t, D) in
    bf16: matmul FLOPs at the bf16 peak, or each operand read once and each
    output written once at the memory rate."""
    bh = B * H
    mat = bh * t * D * 2  # one (BH, T, D) bf16 operand
    row = bh * t * 4  # one float32 (BH, T) row statistic
    work = {  # (FLOP, bytes)
        "flash_fwd": (4 * t * t * D * bh, 3 * mat + mat + row),
        "flash_dkv": (8 * t * t * D * bh, 4 * mat + 2 * row + 2 * mat),
        "flash_dq": (6 * t * t * D * bh, 4 * mat + 2 * row + mat),
        "flash_onepass": (4 * t * t * D * bh, 3 * mat + mat + row),  # K1's work
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


LIBRARY_CALL = {  # what library_ms times for each kernel
    "flash_fwd": "scaled_dot_product_attention forward",
    "flash_dkv": "aten flash backward: dQ, dK and dV together",
    "flash_dq": "aten flash backward: dQ, dK and dV together",
    "flash_onepass": "scaled_dot_product_attention forward",
}

KERNEL_TABLE = {  # name -> (source, TPU kernel it replaces)
    "flash_fwd": ("eav_tpu_torch/csrc/flash_attention.cu",
                  "eav_tpu/ops/pallas/attention.py:73"),
    "flash_dkv": ("eav_tpu_torch/csrc/flash_attention.cu",
                  "eav_tpu/ops/pallas/attention.py:113"),
    "flash_dq": ("eav_tpu_torch/csrc/flash_attention.cu",
                 "eav_tpu/ops/pallas/attention.py:158"),
    "flash_onepass": ("eav_tpu_torch/csrc/flash_attention.cu",
                      "scripts/flash_onepass_experiment.py:25"),
}


# -----------------------------------------------------------------------------
# 4. the model and the frontend on the card against the plain paths
# -----------------------------------------------------------------------------


def check_model_and_frontend() -> None:
    """Full-width AST-base in float32 with flash attention (the kernels)
    against the same weights with math attention; the audio frontend on the
    card against the CPU."""
    import numpy as np
    import torch

    from eav_tpu_torch.ingest.audio import ast_frontend
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.ops.signal import resample_poly

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(2, 1024, 128, generator=gen, device="cuda")
    with torch.no_grad():
        feats = {impl: AST(attn_impl=impl).to("cuda").eval()(x, mode="features")
                 for impl in ("flash", "math")}
    err = max_err(feats["flash"], feats["math"], 1e-3, 1e-3)
    log(f"AST-base float32 pooled features, flash vs math attention: max abs err "
        f"{err:.3g} (atol=rtol=1e-3, float32 sums in another order through 12 layers)")

    rng = np.random.default_rng(0)
    wave = (0.1 * rng.standard_normal((2, 5 * 44100))).astype(np.float32)
    on_card = resample_poly(torch.as_tensor(wave, device="cuda"), 160, 441).cpu().numpy()
    on_cpu = resample_poly(torch.as_tensor(wave), 160, 441).numpy()
    err_rs = float(np.abs(on_card - on_cpu).max())
    fb_card = ast_frontend(on_card, device="cuda")
    fb_cpu = ast_frontend(on_card, device="cpu")
    err_fb = float(np.abs(fb_card - fb_cpu).max())
    if not (err_rs < 1e-5 and err_fb < 1e-3):
        raise AssertionError(f"frontend on the card disagrees with the CPU: {err_rs}, {err_fb}")
    log(f"frontend on the card vs CPU: resample max abs err {err_rs:.3g} (tol 1e-5), "
        f"normalized fbank {err_fb:.3g} (tol 1e-3)")


# -----------------------------------------------------------------------------
# 5. the main path: run_audio with the full-width ast_finetune preset
# -----------------------------------------------------------------------------

# eav_tpu's metrics row (eav_tpu/train/pipeline.py _finish)
METRICS_KEYS = {"accuracy", "weighted_f1", "confusion", "final_train_acc", "epochs",
                "fit_seconds", "samples_per_sec", "load_seconds", "archive_seconds"}


def write_subject(root: str, subject: int = 1, files: int = 10, seconds: int = 20,
                  sr: int = 44100) -> None:
    """A synthetic subject in the EAV layout: subjectNN/Audio/*.wav, the
    emotion as filename token 4, two files per emotion at 44.1 kHz."""
    import numpy as np

    from eav_tpu_torch.core.config import EMOTION_TO_INDEX
    from eav_tpu_torch.ingest.wav import write_wav

    rng = np.random.default_rng(subject)
    adir = os.path.join(root, f"subject{subject:02d}", "Audio")
    os.makedirs(adir)
    emotions = list(EMOTION_TO_INDEX)
    t = np.arange(seconds * sr) / sr
    for i in range(files):
        emo = emotions[i % len(emotions)]
        tone = 0.3 * np.sin(2 * np.pi * (200 + 60 * (i % len(emotions))) * t)
        write_wav(os.path.join(adir, f"subject_{subject:02d}_Speaking_{i}_{emo}_.wav"),
                  tone + 0.05 * rng.standard_normal(t.size), sr)


def run_main_path() -> dict:
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import PhaseConfig, get_preset
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    base = get_preset("ast_finetune")
    preset = base.replace(
        split=dataclasses.replace(base.split, h_idx=6),  # 8 segments per class: 30 train, 10 test
        finetune=dataclasses.replace(
            base.finetune,
            phases=(PhaseConfig(epochs=1, lr=5e-4, freeze=True),
                    PhaseConfig(epochs=1, lr=5e-6, freeze=False)),
        ),
    )
    with tempfile.TemporaryDirectory() as root:
        write_subject(root)
        pipes = ModalityPipelines(root, presets={"audio": preset}, device="cuda")
        A.reset_launches()
        t0 = time.perf_counter()
        res = pipes.run_audio(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (A.flash_fwd, A.flash_dkv, A.flash_dq)}
    hist = res.artifacts["history"]
    m = res.metrics
    log(f"run_audio (ast_finetune, AST-base bf16, 1 frozen + 1 unfrozen epoch, 30 train / "
        f"10 test segments): {wall:.1f} s; losses {hist['loss'].tolist()}, "
        f"accuracy {m['accuracy']}, fit {m['fit_seconds']} s, load {m['load_seconds']} s; "
        f"launches {launches}")
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if not (np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2):
        raise AssertionError(f"bad loss history {hist['loss']}")
    if set(m) != METRICS_KEYS:
        raise AssertionError(f"metrics keys {sorted(m)} != {sorted(METRICS_KEYS)}")
    return launches


# -----------------------------------------------------------------------------
# 6. the unfrozen train step
# -----------------------------------------------------------------------------


def train_step_setup(preset_name: str = "ast_finetune", attn_impl=None):
    """(trainer, optimizer, x, y) for the full-width unfrozen step of a
    preset: AST on (8, 1024, 128) fbanks, ViT on (128, 56, 56, 3) uint8
    frames, as the paths feed them; ``attn_impl`` overrides the preset's."""
    import dataclasses

    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset(preset_name)
    if attn_impl is not None:
        ft = preset.finetune
        preset = preset.replace(finetune=dataclasses.replace(
            ft, model_kwargs={**ft.model_kwargs, "attn_impl": attn_impl}))
    trainer = Trainer(build_model(preset), preset.finetune, device="cuda")
    opt = make_optimizer(trainer.model, preset.finetune)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bs = preset.finetune.batch_size
    if preset_name == "ast_finetune":
        x = torch.randn(bs, 1024, 128, generator=gen, device="cuda")
    else:
        side = preset.vision.face_image_size
        x = torch.randint(0, 256, (bs, side, side, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
    y = torch.randint(0, 5, (bs,), generator=gen, device="cuda")
    for _ in range(3):  # warm-up: cuBLAS handles, allocator, optimizer state
        trainer.train_step(opt, x, y)
    torch.cuda.synchronize()
    return trainer, opt, x, y


def time_train_step(card: str, preset_name: str = "ast_finetune",
                    what: str = "AST-base, unfrozen, bs 8, bf16, flash kernels",
                    attn_impl=None) -> None:
    import torch

    torch.cuda.reset_peak_memory_stats()
    trainer, opt, x, y = train_step_setup(preset_name, attn_impl)
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        trainer.train_step(opt, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    bs = x.shape[0]
    log(f"train step ({what}): median {ms:.2f} ms of 10, {bs / ms * 1e3:.2f} samples/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")


def profile_train_step(card: str, preset_name: str = "ast_finetune", steps: int = 5,
                       top: int = 20) -> None:
    """Device time per step by kernel, from torch.profiler over ``steps``
    steady-state train steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, opt, x, y = train_step_setup(preset_name)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            trainer.train_step(opt, x, y)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [  # device kernels only: GPU-side user annotations span kernels
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
    ]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if not kernels or busy_ms == 0:
        log("profile: the trace holds no device time (not measured)")
        return
    log(f"profile of the {preset_name} step over {steps} steps on {card}: wall {wall_ms:.2f} "
        f"ms/step under the profiler, device busy {busy_ms:.2f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"  {ms:8.3f} ms/step {100 * ms / busy_ms:5.1f}%  x{e.count // steps:<4d} {e.key[:110]}")


# -----------------------------------------------------------------------------
# 7. the one-pass experiment
# -----------------------------------------------------------------------------


def run_experiment(card: str) -> dict:
    """The experiment's run on the card; returns the launch counts of that run."""
    import torch

    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.scripts.flash_onepass_experiment import run

    A.reset_launches()
    res = run(device="cuda")
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in A.KERNELS}
    atol = TOLERANCE["bfloat16"]["out"][0]
    log(f"experiment (B, T, H, D) {tuple(res['shape'])} bf16, mean of {res['steps']} calls: "
        f"fwd streaming (K1) {res['stream_ms']:.3f} ms, fwd one-pass (K5) "
        f"{res['onepass_ms']:.3f} ms, max|err| {res['max_abs_err']:.3g} (atol {atol}); "
        f"GELU (8, 1214, 3072) bf16: erf {res['gelu_erf_ms']:.4f} ms, tanh "
        f"{res['gelu_tanh_ms']:.4f} ms; launches {launches}; on {card}")
    if not (launches["flash_onepass"] > 0 and launches["flash_fwd"] > 0):
        raise AssertionError(f"the experiment did not launch K5 and K1: {launches}")
    if not res["max_abs_err"] <= atol:
        raise AssertionError(f"one-pass vs streaming max|err| {res['max_abs_err']} > {atol}")
    return launches


# -----------------------------------------------------------------------------
# 8. the vision path: run_vision with the full-width vit_finetune preset
# -----------------------------------------------------------------------------


def write_frame_cache(cache_dir: str, preset, subject: int = 1, trials: int = 40) -> None:
    """A synthetic subject's frame cache where ``load_vision`` reads it:
    uint8 (trials, 25, 56, 56, 3) face crops, classes in turn."""
    import numpy as np

    from eav_tpu_torch.train.pipeline import _cfg_hash

    cfg = preset.vision
    rng = np.random.default_rng(subject)
    side = cfg.face_image_size
    x = rng.integers(0, 256, size=(trials, cfg.frames_per_sample, side, side, 3), dtype=np.uint8)
    y = (np.arange(trials) % 5).astype(np.int32)
    np.savez(os.path.join(cache_dir, f"s{subject:02d}_vis_{_cfg_hash(cfg)}.npz"), x=x, y=y)


def run_vision_path() -> None:
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import PhaseConfig, get_preset
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    base = get_preset("vit_finetune")
    preset = base.replace(
        split=dataclasses.replace(base.split, h_idx=6),  # 8 trials per class: 30 train, 10 test
        finetune=dataclasses.replace(
            base.finetune,
            phases=(PhaseConfig(epochs=1, lr=5e-4, freeze=True),
                    PhaseConfig(epochs=1, lr=5e-6, freeze=False)),
        ),
    )
    with tempfile.TemporaryDirectory() as root:
        cache, logits = os.path.join(root, "cache"), os.path.join(root, "logits")
        os.makedirs(cache)
        write_frame_cache(cache, preset)
        pipes = ModalityPipelines(os.path.join(root, "EAV"), cache_dir=cache, logits_dir=logits,
                                  presets={"vision": preset}, device="cuda")
        A.reset_launches()
        t0 = time.perf_counter()
        res = pipes.run_vision(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}
        test_arch = np.load(os.path.join(logits, "s01_vision_test.npy"))
        train_arch = np.load(os.path.join(logits, "s01_vision_train.npy"))
    hist = res.artifacts["history"]
    m = res.metrics
    log(f"run_vision (vit_finetune, ViT-base bf16, math attention, 1 frozen + 1 unfrozen "
        f"epoch, 750 train / 250 test frames of 30 / 10 trials): {wall:.1f} s; losses "
        f"{hist['loss'].tolist()}, trial accuracy {m['accuracy']}, fit {m['fit_seconds']} s, "
        f"{m['samples_per_sec']} frames/s, load {m['load_seconds']} s; archives test "
        f"{test_arch.shape}, train {train_arch.shape}; launches {launches}")
    if not (np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2):
        raise AssertionError(f"bad loss history {hist['loss']}")
    if set(m) != METRICS_KEYS:
        raise AssertionError(f"metrics keys {sorted(m)} != {sorted(METRICS_KEYS)}")
    if test_arch.shape != (10, 5) or train_arch.shape != (30, 5) or not np.isfinite(test_arch).all():
        raise AssertionError(f"archives not trial-voted: {test_arch.shape}, {train_arch.shape}")
    if sum(map(sum, m["confusion"])) != 10:
        raise AssertionError(f"the confusion matrix does not count 10 trials: {m['confusion']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from eav_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; TF32 off for matmuls and cuDNN")

    t0 = time.perf_counter()
    build.build("flash_attention")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    usage = build.resource_usage("flash_attention")
    log("registers (spill store bytes) by kernel<D>: " + ", ".join(
        f"{n} {regs} ({spill})" for n, (regs, spill) in sorted(usage.items()) if "mma" in n))

    errs = {}
    for i, (t_pad, t, dt) in enumerate(
        [(T_AST, T_AST, "bfloat16"), (T_AST, T_AST, "float32"), (197, 197, "bfloat16"),
         (197, 197, "float32"), (1280, T_AST, "bfloat16"), (1280, T_AST, "float32")]
    ):
        found = check_kernels(t_pad, t, dt, seed=i)
        if i == 0:  # the main path's shape and type
            errs = found
    times = time_kernels(seed=10)
    bounds = kernel_bounds(T_AST)
    for n, (ms, ms_run, plain, lib, lib_run) in times.items():
        log(f"{n}: {ms:.3f} ms one call, {ms_run:.3f} ms a call in a run of 20 (plain "
            f"{plain:.3f} ms, library {lib:.3f} / {lib_run:.3f} ms [{LIBRARY_CALL[n]}], bound "
            f"{bounds[n][0]:.4f} ms by {bounds[n][1]}) at BH {B * H}, T {T_AST}, D {D}, bf16 "
            f"on {card}")
    check_model_and_frontend()

    launches = run_main_path()
    time_train_step(card)
    profile_train_step(card)
    # each kernel's launches from its own path: K1-K3 run_audio's, K5 the experiment's
    launches["flash_onepass"] = run_experiment(card)["flash_onepass"]
    run_vision_path()
    vit_step = "ViT-base, unfrozen, bs 128, uint8 56x56 frames resized in the model, bf16"
    time_train_step(card, "vit_finetune", f"{vit_step}, math attention (the preset)")
    profile_train_step(card, "vit_finetune", top=12)
    # whether the flash kernels should serve T 197: the same step through K1-K3
    time_train_step(card, "vit_finetune", f"{vit_step}, flash kernels", attn_impl="flash")

    kernels = []
    for n, (source, replaces) in KERNEL_TABLE.items():
        ms, ms_run, plain, lib, lib_run = times[n]
        kernels.append({
            "name": n, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[n], "max_abs_err": errs[n], "ms": ms, "ms_run": ms_run,
            "plain_ms": plain,
            "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": lib,
            "library_ms_run": lib_run,
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
