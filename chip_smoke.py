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
   and its profile, then the same step through the flash kernels;
10. EEG path: a synthetic subject at the real shapes written with
   ``scipy.io.savemat`` on a host thread during the build, waited for
   before phase 3 (``seg`` (10000, 30, 200) at 500 Hz, a (10, 200) one-hot
   with the classes in turn); ``preprocess_eeg`` on the card (the resample
   and the SOS bandpass) against a float64 scipy oracle of the reference's
   chain (within 1e-5 of the scale), and timed alone;
   ``ModalityPipelines.run_eeg`` with the full-width ``eegnet_subject`` (EEGNet, 30 x 500, kern 300, batch 32) and
   ``conformer_eeg`` (12 layers, embed 40, T 488) presets, 2 epochs each on
   the full 280 / 120 split; finite losses, the metrics keys, a confusion
   matrix of 120, the archives' shapes, and the head's max-norm after the
   fit;
11. the EEG train steps at batch 32 (median of 10, peak memory): EEGNet with
   the direct and with the FFT temporal convolution in turns (direct, FFT,
   FFT, direct), and the conformer; a profile of the conformer's step and of
   EEGNet's in each temporal mode, for their device ms/step. The EEG path has
   no hand-written kernel (the conformer's attention is math at D 40, as in
   the JAX package);
12. determinism: ``run_eeg`` with the full-width conformer twice in the
   trainer's deterministic mode (``torch.use_deterministic_algorithms``)
   must give identical losses and test logits; the EEGNet and conformer
   steps timed with the mode and without it, in turns;
13. stacked EEG: subjects 2..8 served by links to subject 1's ``.mat`` files
   (the same data, their own seeds), ``run_stacked`` for ``eeg`` and
   ``eeg_conformer`` at S 8 and 4 in the deterministic mode: the row keys (the
   serial keys and ``group_size``), both archives of every subject, every
   subject's max-norm bounds; stacked == serial for the first and last subject:
   EEGNet's test logits against serial ``run_eeg`` fits to rtol = atol =
   2e-4, the conformer's loss and gradients of one full-width step to 2e-4
   of the largest entry, and its losses and test logits after a full-width
   fit of 2 steps (dropout on, the sticky eval mode, max-norm) to 0.1 (its
   fit is chaotic, PERF.md); subject 1 against subject 2's serial fit or
   step, subject 1 fit with subject 2's dropout masks and a fit without
   max-norm must fail those checks;
14. stacked steps: one stacked train step on random tensors of the real
   shape, EEGNet at S 1, 8 and 42 and the conformer at S 8 and 42, in ms a
   subject-step beside the serial step of phase 11, and peak memory;
15. stacked AST-base: ``run_stacked([1, 2], "audio")`` (subject 2 a link to
   subject 1's wavs) with the full-width ``ast_finetune`` preset, one frozen
   and one unfrozen epoch: ``vmap`` with math attention and remat 'attn';
   the flash kernels are not launched; the stacked unfrozen step timed at
   S 2 with its peak memory;
16. fusion: ``run_fusion(s, mods=("eeg", "eeg_conformer"))`` over the
   archives of phase 13 for each of the conformer group's 4 subjects at the
   preset's 100 epochs: the row keys and finite fused logits.

Float32 checks run with TF32 off for both matmuls and cuDNN convolutions, so
float32 means float32 throughout the run. ``CUBLAS_WORKSPACE_CONFIG`` is set
before torch is imported (phases 12-13 need it), so every phase, the timed
AST and ViT steps included, runs with it set. The last lines are the ``kernels``
JSON, the ``nvidia-smi`` line and ``{"ok": true, "device": {...}}``. Exits
non-zero without that line when there is no GPU or a phase fails.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import statistics
import subprocess
import sys
import time

# cuBLAS is deterministic only with this workspace setting in the environment
# before the process's first cuBLAS call. The AST phases call cuBLAS long
# before the deterministic mode of phases 12-13 is turned on, so it is set
# here, before torch is imported.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    """A phase's end, with the seconds since the script started."""
    log(f"[{time.perf_counter() - T_START:.1f} s] {phase} done")


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
    out = A.flash_attention_bh(*leaves, t)
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
        torch.autograd.grad(A.flash_attention_bh(*flat, t), flat, do)

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


def run_main_path(with_result: bool = False):
    """``run_audio`` (ast_finetune, full width, 1 frozen + 1 unfrozen epoch)
    on a synthetic subject -> the launches of K1-K3 in it (and the task's
    result with ``with_result``)."""
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
    return (launches, res) if with_result else launches


# -----------------------------------------------------------------------------
# 6. the unfrozen train step
# -----------------------------------------------------------------------------


def step_inputs(preset, lead=()):
    """Random (x, y) of a preset's train batch as its path feeds it, with
    ``lead`` axes in front (a subject stack): AST (8, 1024, 128) fbanks, the
    SCNN (64, 180) features, ViT (128, 56, 56, 3) uint8 frames, ResNetAttn
    (32, 224, 224, 3) normalized frames, EEGNet and the conformer (32, 30,
    500) trials."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    bs = (*lead, preset.finetune.batch_size)
    if preset.finetune.model == "scnn_audio":
        x = torch.randn(*bs, 180, generator=gen, device="cuda")
    elif preset.finetune.model == "resnet_attn":
        side = preset.vision.image_size
        x = torch.randn(*bs, side, side, 3, generator=gen, device="cuda")
    elif preset.audio is not None:
        x = torch.randn(*bs, 1024, 128, generator=gen, device="cuda")
    elif preset.vision is not None:
        side = preset.vision.face_image_size
        x = torch.randint(0, 256, (*bs, side, side, 3), generator=gen, device="cuda",
                          dtype=torch.uint8)
    else:
        x = torch.randn(*bs, preset.eeg.channels, preset.eeg.samples_per_chunk, generator=gen,
                        device="cuda")
    return x, torch.randint(0, 5, bs, generator=gen, device="cuda")


def train_step_setup(preset_name: str = "ast_finetune", **model_kw):
    """(trainer, optimizer, x, y) for the full-width unfrozen train-mode step
    of a preset (``step_inputs``); ``model_kw`` overrides the preset's model
    kwargs."""
    import dataclasses

    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset(preset_name)
    ft = preset.finetune
    preset = preset.replace(finetune=dataclasses.replace(
        ft, model_kwargs={**ft.model_kwargs, **model_kw}))
    trainer = Trainer(build_model(preset), preset.finetune, device="cuda")
    trainer.model.train()
    opt = make_optimizer(trainer.model, preset.finetune)
    x, y = step_inputs(preset)
    for _ in range(3):  # warm-up: cuBLAS handles, allocator, optimizer state
        trainer.train_step(opt, x, y)
    torch.cuda.synchronize()
    return trainer, opt, x, y


def time_train_step(card: str, preset_name: str = "ast_finetune",
                    what: str = "AST-base, unfrozen, bs 8, bf16, flash kernels",
                    deterministic: bool = False, **model_kw) -> float:
    """Median ms of 10 train steps, printed with samples/s and peak memory;
    with ``deterministic``, under torch's deterministic algorithms."""
    import torch

    from eav_tpu_torch.core.device import deterministic_algorithms

    torch.cuda.reset_peak_memory_stats()
    with deterministic_algorithms(deterministic):
        trainer, opt, x, y = train_step_setup(preset_name, **model_kw)
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
    return ms


def profile_train_step(card: str, preset_name: str = "ast_finetune", steps: int = 5,
                       top: int = 20, **model_kw) -> float:
    """Device time per step by kernel, from torch.profiler over ``steps``
    steady-state train steps; returns the device ms per step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer, opt, x, y = train_step_setup(preset_name, **model_kw)
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
        return float("nan")
    what = ", ".join(f"{k} {v}" for k, v in model_kw.items())
    log(f"profile of the {preset_name} step{f' ({what})' if what else ''} over {steps} steps on {card}: wall {wall_ms:.2f} "
        f"ms/step under the profiler, device busy {busy_ms:.2f} ms/step "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / steps
        log(f"  {ms:8.3f} ms/step {100 * ms / busy_ms:5.1f}%  x{e.count // steps:<4d} {e.key[:110]}")
    return busy_ms


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


# -----------------------------------------------------------------------------
# 10. the EEG path: preprocess on the card, run_eeg with both EEG presets
# -----------------------------------------------------------------------------


def write_eeg_subject(root: str, subject: int = 1, samples: int = 10000, chans: int = 30,
                      trials: int = 200) -> None:
    """A synthetic subject in the EAV layout, at the real shapes:
    subjectNN/EEG/subjectNN_eeg.mat with ``seg`` (samples, chans, trials)
    float64 at 500 Hz, and subjectNN_eeg_label.mat with a (10, trials)
    one-hot whose rows come in turn (the listening rows 1, 3, 5, 7, 9 give
    100 trials, 400 chunks, 80 a class)."""
    import numpy as np
    import scipy.io

    rng = np.random.default_rng(subject)
    edir = os.path.join(root, f"subject{subject:02d}", "EEG")
    os.makedirs(edir)
    name = f"subject{subject:02d}"
    scipy.io.savemat(os.path.join(edir, f"{name}_eeg.mat"),
                     {"seg": rng.standard_normal((samples, chans, trials))})
    label = np.zeros((10, trials))
    label[np.arange(trials) % 10, np.arange(trials)] = 1
    scipy.io.savemat(os.path.join(edir, f"{name}_eeg_label.mat"), {"label": label})


def eeg_oracle(seg, cfg):
    """The reference's chain (`Dataload_eeg.py:85-139`) in float64 with
    scipy and MATLAB F-order reshapes: (ch, t, tri) -> (ch, 500, 4 tri)."""
    import numpy as np
    import scipy.signal as sps

    ch, t, tri = seg.shape
    down = cfg.fs_orig // cfg.fs_target
    flat = sps.resample_poly(np.reshape(seg, (ch, t * tri), order="F"), 1, down, axis=1)
    sos = sps.butter(cfg.butter_order, cfg.band, btype="bandpass", fs=cfg.fs_target,
                     output="sos")
    new_t = t // down
    seg_f = sps.sosfilt(sos, flat, axis=1).reshape((ch, new_t, tri), order="F")
    chunk = cfg.samples_per_chunk
    k = new_t // chunk
    return seg_f.reshape((ch, chunk, k, tri), order="F").reshape((ch, chunk, k * tri), order="F")


def check_eeg_preprocess(root: str, card: str) -> None:
    """``preprocess_eeg`` on the card in float32 against the float64 oracle,
    within 1e-5 of the scale (a sound float32 run reads about 5e-7; a fault
    in the carries or the resample, or bf16 products, reads far above),
    then timed alone: median of 5 after a warm-up, host clock around a
    synchronize."""
    import numpy as np
    import torch

    from eav_tpu_torch.core.config import EEGPreprocConfig
    from eav_tpu_torch.ingest.eeg import DataLoadEEG, preprocess_eeg

    cfg = EEGPreprocConfig()
    seg, _ = DataLoadEEG(1, cfg, root, device="cuda").load_mat()
    x = torch.as_tensor(np.ascontiguousarray(seg)).to("cuda", torch.float32)
    got = preprocess_eeg(x, cfg).cpu().numpy()
    want = eeg_oracle(seg, cfg)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    if not (got.shape == want.shape == (30, 500, 800) and np.isfinite(got).all() and err < 1e-5):
        raise AssertionError(f"preprocess_eeg on the card: shape {got.shape}, rel err {err}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preprocess_eeg(x, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"preprocess_eeg on the card, (30, 10000, 200) float32 -> (30, 500, 800): max abs err "
        f"{err:.3g} of the scale against float64 scipy (tol 1e-5); median "
        f"{statistics.median(times[1:]) * 1e3:.2f} ms of 5 (resample + order-5 SOS bandpass "
        f"over 30 x 400000 samples); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}")


EEG_BOUNDS = {"eeg": {"head.weight": 1.0, "conv_depthwise.weight": 1.0},  # max-norms
              "eeg_conformer": {"head.weight": 0.5}}


def eeg_presets(epochs: int = 2) -> dict:
    """The full-width ``eegnet_subject`` and ``conformer_eeg`` presets cut
    to ``epochs`` epochs, and ``fusion_sweep``, under their modality keys."""
    import dataclasses

    from eav_tpu_torch.core.config import get_preset

    presets = {"fusion": get_preset("fusion_sweep")}
    for key, name in (("eeg", "eegnet_subject"), ("eeg_conformer", "conformer_eeg")):
        base = get_preset(name)
        phase = dataclasses.replace(base.finetune.phases[0], epochs=epochs)
        presets[key] = base.replace(finetune=dataclasses.replace(base.finetune, phases=(phase,)))
    return presets


def eeg_pipelines(root: str, logits: str, deterministic: bool = False):
    """Pipelines over the synthetic EEG subjects under ``root`` with the
    trial cache shared by every phase."""
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    return ModalityPipelines(os.path.join(root, "EAV"), cache_dir=os.path.join(root, "cache"),
                             logits_dir=os.path.join(root, logits), presets=eeg_presets(),
                             device="cuda", deterministic=deterministic)


def max_row_norms(params: dict, key: str) -> dict:
    """Each max-normed weight's largest row norm (a subject's state_dict)."""
    return {n: float(params[n].flatten(1).norm(dim=1).max()) for n in EEG_BOUNDS[key]}


def check_max_norms(norms: dict, key: str) -> None:
    for n, bound in EEG_BOUNDS[key].items():
        if norms[n] > bound * (1 + 1e-5):
            raise AssertionError(f"{n} row norm {norms[n]} above its max-norm {bound}")


def timed_write_eeg_subject(root: str) -> float:
    """``write_eeg_subject`` under ``root``/EAV -> its seconds."""
    t0 = time.perf_counter()
    write_eeg_subject(os.path.join(root, "EAV"))
    return time.perf_counter() - t0


def run_eeg_path(card: str, root: str) -> None:
    """``run_eeg`` with the full-width EEGNet and conformer presets, 2 epochs
    each, on the synthetic subject under ``root``; the conformer reads the
    trials EEGNet's run cached."""
    import numpy as np
    import torch

    presets = eeg_presets()
    check_eeg_preprocess(os.path.join(root, "EAV"), card)
    logits = os.path.join(root, "logits")
    pipes = eeg_pipelines(root, "logits")
    for key in ("eeg", "eeg_conformer"):
        t0 = time.perf_counter()
        res = pipes.run_eeg(1, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        test_arch = np.load(os.path.join(logits, f"s01_{key}_test.npy"))
        train_arch = np.load(os.path.join(logits, f"s01_{key}_train.npy"))
        hist, m, params = res.artifacts["history"], res.metrics, res.artifacts["params"]
        norms = max_row_norms(params, key)
        log(f"run_eeg ({presets[key].name}, full width, float32, 2 epochs, 280 train / 120 "
            f"test): {wall:.1f} s; losses {hist['loss'].tolist()}, train acc "
            f"{hist['train_acc'].tolist()}, test acc {hist['test_acc'].tolist()}, accuracy "
            f"{m['accuracy']}, load {m['load_seconds']} s, fit {m['fit_seconds']} s, "
            f"{m['samples_per_sec']} samples/s, archive {m['archive_seconds']} s; archives "
            f"test {test_arch.shape}, train {train_arch.shape}; max row norms {norms} "
            f"(max-norm {EEG_BOUNDS[key]}) on {card}")
        if not (np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2):
            raise AssertionError(f"bad loss history {hist['loss']}")
        if set(m) != METRICS_KEYS:
            raise AssertionError(f"metrics keys {sorted(m)} != {sorted(METRICS_KEYS)}")
        if sum(map(sum, m["confusion"])) != 120:
            raise AssertionError(f"the confusion matrix does not count 120: {m['confusion']}")
        if test_arch.shape != (120, 5) or train_arch.shape != (280, 5):
            raise AssertionError(f"archive shapes {test_arch.shape}, {train_arch.shape}")
        if not np.isfinite(test_arch).all():
            raise AssertionError("non-finite test logits")
        check_max_norms(norms, key)


def eegnet_temporal_modes(card: str) -> float:
    """EEGNet's train step with the direct (``conv``, the preset's) and the
    FFT temporal convolution in turns (conv, fft, fft, conv), and a profile
    of each for its device ms/step -> the mean of the conv medians."""
    from eav_tpu_torch.core.config import get_preset

    what = "EEGNet (eegnet_subject), bs 32, 30 x 500, kern 300, float32, train mode"
    step_ms = {"conv": [], "fft": []}
    for mode in ("conv", "fft", "fft", "conv"):  # in turns, on one card
        step_ms[mode].append(time_train_step(card, "eegnet_subject",
                                             f"{what}, temporal_mode {mode}", temporal_mode=mode))
    log(f"EEGNet step, fft / conv in turns: "
        f"{step_ms['fft'][0] / step_ms['conv'][0]:.3f}, {step_ms['fft'][1] / step_ms['conv'][1]:.3f} "
        f"(the preset takes {get_preset('eegnet_subject').finetune.model_kwargs['temporal_mode']!r})")
    device_ms = {mode: profile_train_step(card, "eegnet_subject", top=12, temporal_mode=mode)
                 for mode in ("conv", "fft")}
    log(f"EEGNet step, device ms/step under the profiler: conv {device_ms['conv']:.3f}, fft "
        f"{device_ms['fft']:.3f} (fft / conv {device_ms['fft'] / device_ms['conv']:.3f})")
    return statistics.mean(step_ms["conv"])


# -----------------------------------------------------------------------------
# 12. determinism: a repeated fit, and what the mode costs a step
# -----------------------------------------------------------------------------


def check_determinism(card: str, root: str) -> dict:
    """``run_eeg`` with the full-width conformer (dropout 0.5, shuffled
    batches) twice in the deterministic mode: the same losses and test
    logits, bit for bit. Then the EEGNet and conformer steps without the mode
    and with it, in turns (off, on, on, off) -> {preset: {False: [ms], True:
    [ms]}}."""
    import numpy as np

    runs = []
    for i in range(2):
        pipes = eeg_pipelines(root, f"det{i}", deterministic=True)
        res = pipes.run_eeg(1, "eeg_conformer")
        runs.append((res.artifacts["history"],
                     np.load(os.path.join(root, f"det{i}", "s01_eeg_conformer_test.npy"))))
    (h0, l0), (h1, l1) = runs
    same = all(np.array_equal(h0[k], h1[k]) for k in h0) and np.array_equal(l0, l1)
    log(f"determinism: run_eeg (conformer_eeg, full width, 2 epochs) twice in the deterministic "
        f"mode: losses {h0['loss'].tolist()} / {h1['loss'].tolist()}, test logits "
        f"{'identical' if same else 'DIFFER'} (max abs diff {float(np.abs(l0 - l1).max()):.3g})")
    if not same:
        raise AssertionError("a fit in the deterministic mode did not repeat")
    cost = {}
    for name, what in (("eegnet_subject", "EEGNet (eegnet_subject), bs 32, float32, conv"),
                       ("conformer_eeg", "EEG conformer (conformer_eeg), bs 32, float32")):
        cost[name] = {False: [], True: []}
        for on in (False, True, True, False):
            cost[name][on].append(time_train_step(card, name, f"{what}, deterministic {on}",
                                                  deterministic=on))
        on_ms, off_ms = cost[name][True], cost[name][False]
        log(f"deterministic mode, {name} step, on / off in turns: {on_ms[0] / off_ms[0]:.3f}, "
            f"{on_ms[1] / off_ms[1]:.3f} (on {on_ms} ms, off {off_ms} ms)")
    return cost


# -----------------------------------------------------------------------------
# 13. stacked EEG: run_stacked against the serial fits
# -----------------------------------------------------------------------------

GROUP = 8  # subjects of the stacked EEGNet group
CONFORMER_GROUP = 4  # of the stacked conformer group, and of the fusion phase
STACK_TOL = (2e-4, 2e-4)  # stacked == serial, the JAX package's bound (tests/test_parallel.py)
# the conformer's 2-step fit, stacked against serial: test logits' max abs
# err. Adam's first update is about lr * sign(g), and a gradient entry near 0
# whose sign roundoff flips moves its weight by 2 lr: sound fits read up to
# 0.031 on the card, the planted faults 0.34-0.90 on the CPU (PERF.md)
TRAJ_TOL = 0.1


def link_eeg_subjects(root: str, subjects) -> None:
    """Subjects served by links to subject 1's ``.mat`` files under their
    own names: the same data, fit at their own seeds."""
    src = os.path.join(root, "EAV", "subject01", "EEG")
    for s in subjects:
        name = f"subject{s:02d}"
        edir = os.path.join(root, "EAV", name, "EEG")
        os.makedirs(edir)
        for suffix in ("eeg.mat", "eeg_label.mat"):
            os.symlink(os.path.join(src, f"subject01_{suffix}"),
                       os.path.join(edir, f"{name}_{suffix}"))


def stacked_against_serial(root: str, key: str, subjects, tag: str) -> dict:
    """Test logits and BatchNorm running stats of ``run_stacked`` over
    ``subjects`` against serial ``run_eeg`` fits of the first and last
    subject, in the deterministic mode, to ``STACK_TOL``; subject 1's
    stacked logits against subject 2's serial fit must fail the check ->
    max abs errors of the logits by subject."""
    import numpy as np
    import torch

    stacked = eeg_pipelines(root, f"{tag}_stacked", True)
    serial = eeg_pipelines(root, f"{tag}_serial", True)
    rows = stacked.run_stacked(subjects, key)
    arch = lambda d, s: torch.as_tensor(np.load(  # noqa: E731
        os.path.join(root, f"{tag}_{d}", f"s{s:02d}_{key}_test.npy")))
    errs = {}
    for s in (subjects[0], subjects[-1], subjects[1]):
        fit = serial.run_eeg(s, key).artifacts["params"]
        if s != subjects[1]:
            errs[s] = max_err(arch("stacked", s), arch("serial", s), *STACK_TOL)
            for n, v in fit.items():
                if "running_" in n:
                    max_err(rows[s].artifacts["params"][n], v, *STACK_TOL)
    must_reject(arch("stacked", subjects[0]), arch("serial", subjects[1]), *STACK_TOL,
                f"subject {subjects[0]}'s stacked logits against subject {subjects[1]}'s serial fit")
    return errs


def stacked_step_against_serial(preset_name: str, subjects: int) -> dict:
    """One stacked train step of ``subjects`` subjects at full width (the
    real batch, each subject's init and dropout masks from its own seed)
    against each subject's serial step, in the deterministic mode: the loss
    and every gradient, the gradients to ``STACK_TOL[0]`` of the largest
    serial entry. Subject 1's stacked gradients against subject 2's serial
    ones must fail -> relative errors of the first and last subject."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.core.device import deterministic_algorithms
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.models.dropout import set_generator
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = get_preset(preset_name)
    seeds = list(range(1, subjects + 1))
    with deterministic_algorithms(True):
        sp = stacked_trainer(preset)
        stack = sp.init_stack(seeds)
        sp.model.train()
        x, y = step_inputs(preset, (subjects,))
        loss, _ = sp.train_step(stack, x, y)
        serial = Trainer(build_model(preset), preset.finetune, device="cuda")

        def serial_step(s):
            serial.model.reset_parameters(torch.Generator().manual_seed(seeds[s]))
            set_generator(serial.model, torch.Generator(device="cuda").manual_seed(seeds[s]))
            serial.model.train()
            one, _ = serial.train_step(make_optimizer(serial.model, preset.finetune), x[s], y[s])
            return float(one), {n: p.grad for n, p in serial.model.named_parameters()}

        def rel_err(s, grads):
            scale = max(float(g.abs().max()) for g in grads.values())
            return max(float((stack.params[n].grad[s] - g).abs().max())
                       for n, g in grads.items()) / scale

        errs = {}
        for s in (0, subjects - 1):
            one, grads = serial_step(s)
            errs[s + 1] = rel_err(s, grads)
            for n, v in serial.model.named_buffers():
                if "running_" in n:  # BatchNorm's stats after the step
                    max_err(stack.buffers[n][s], v, *STACK_TOL)
            if errs[s + 1] > STACK_TOL[0] or abs(one - float(loss[s])) > STACK_TOL[0] * abs(one):
                raise AssertionError(f"{preset_name} subject {s + 1}: stacked step loss "
                                     f"{float(loss[s])} vs serial {one}, gradients {errs[s + 1]:.3g}")
        if rel_err(0, serial_step(1)[1]) <= STACK_TOL[0]:
            raise AssertionError("the check passed a planted fault: subject 1's stacked gradients "
                                 "against subject 2's serial step")
    return errs


def stacked_fit_against_serial(subjects: int):
    """The full-width conformer's fit of 2 epochs of one step (30 random
    train trials, 120 test, shuffled, dropout 0.5, the second epoch in the
    sticky eval mode) stacked over ``subjects`` subjects against each
    subject's serial ``Trainer.fit``, in the deterministic mode: the loss
    histories to ``STACK_TOL[0]`` relative, the test logits to
    ``TRAJ_TOL``. Two planted faults must fail the logits' check: subject 1
    fit with subject 2's dropout masks, and the stack fit without max-norm
    Every reading is logged before any check raises."""
    import dataclasses

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    class OtherMasks(SubjectParallelTrainer):
        """Subject 1's dropout masks drawn from subject 2's generator."""

        def init_stack(self, seeds, init_params=None):
            stack = super().init_stack(seeds, init_params)
            stack.dropout_gens[0] = torch.Generator(device="cuda").manual_seed(seeds[1])
            return stack

    preset = get_preset("conformer_eeg")
    base = preset.finetune
    cfg = dataclasses.replace(base, phases=(dataclasses.replace(base.phases[0], epochs=2),))
    rng = np.random.default_rng(3)
    n_tr, n_te = 30, 120
    data = (rng.standard_normal((subjects, n_tr, 30, 500), dtype=np.float32),
            np.stack([rng.permutation(n_tr) % 5 for _ in range(subjects)]),
            rng.standard_normal((subjects, n_te, 30, 500), dtype=np.float32),
            np.tile(np.arange(n_te) % 5, (subjects, 1)))
    seeds = list(range(1, subjects + 1))

    def stacked(cls=SubjectParallelTrainer, maxnorm: bool = True):
        sp = cls(build_model(preset), cfg, device="cuda", deterministic=True)
        if not maxnorm:
            sp.inner.maxnorm_rules = []
        return sp.fit_stacked(data, seeds=seeds)

    fit = stacked()
    errs, loss_errs, serial = {}, {}, []
    for s in range(subjects):
        one = Trainer(build_model(preset), cfg, device="cuda", deterministic=True).fit(
            tuple(a[s] for a in data), seed=seeds[s])
        serial.append(one.outputs_test)
        want = one.history["loss"]
        loss_errs[s + 1] = float(np.abs(fit.history["loss"][s] - want).max() / np.abs(want).max())
        errs[s + 1] = float(np.abs(fit.outputs_test[s] - one.outputs_test).max())
    faults = {what: float(np.abs(res.outputs_test[0] - serial[0]).max())
              for what, res in (("subject 2's masks", stacked(OtherMasks)),
                                ("no max-norm", stacked(maxnorm=False)))}
    log(f"stacked == serial, eeg_conformer (S {subjects}, a fit of 2 epochs of one step, 30 train "
        f"/ 120 test, dropout on, sticky eval): test logits max abs err {errs} (bound {TRAJ_TOL}), "
        f"losses' relative err {loss_errs} (bound {STACK_TOL[0]}); subject 1 against its serial "
        f"fit with the planted faults: {faults}, each must pass the bound")
    if max(errs.values()) > TRAJ_TOL or max(loss_errs.values()) > STACK_TOL[0]:
        raise AssertionError("the stacked conformer's fit left its serial fits")
    if min(faults.values()) <= TRAJ_TOL:
        raise AssertionError(f"the check passed a planted fault: {faults}")


def run_stacked_eeg(card: str, root: str):
    """``run_stacked`` for EEGNet at S ``GROUP`` and the conformer at S
    ``CONFORMER_GROUP`` in the deterministic mode: the rows, archives and
    max-norms of every subject, and stacked == serial: EEGNet's test logits
    after its 2-epoch fit (``stacked_against_serial``); the conformer's one
    step of gradients (``stacked_step_against_serial``) and its fit of 2
    steps (``stacked_fit_against_serial``), since its fit at lr 1e-3 carries
    a change in the last bit of a product into the test logits at about 1e3
    times its size within 2 steps, and to 0.8 within the 18 steps of its
    2-epoch fit (PERF.md)."""
    import numpy as np
    import torch

    subjects = list(range(1, GROUP + 1))
    link_eeg_subjects(root, subjects[1:])
    stacked = eeg_pipelines(root, "stacked", deterministic=True)
    for key, group in (("eeg", subjects), ("eeg_conformer", subjects[:CONFORMER_GROUP])):
        t0 = time.perf_counter()
        rows = stacked.run_stacked(group, key)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        arch = lambda s, split: np.load(  # noqa: E731
            os.path.join(root, "stacked", f"s{s:02d}_{key}_{split}.npy"))
        norms = {s: max_row_norms(rows[s].artifacts["params"], key) for s in group}
        for s in group:
            if set(rows[s].metrics) != METRICS_KEYS | {"group_size"}:
                raise AssertionError(f"stacked row keys {sorted(rows[s].metrics)}")
            if arch(s, "test").shape != (120, 5) or arch(s, "train").shape != (280, 5):
                raise AssertionError(f"subject {s}'s archives are not (120, 5) and (280, 5)")
            if not np.isfinite(arch(s, "test")).all():
                raise AssertionError(f"subject {s}'s test logits are not finite")
            check_max_norms(norms[s], key)
        m = rows[1].metrics
        log(f"run_stacked ({key}, S {len(group)}, full width, 2 epochs, 280 / 120, deterministic): "
            f"{wall:.1f} s, fit {m['fit_seconds']} s ({m['samples_per_sec']} samples/s for the "
            f"group), load {m['load_seconds']} s; rows with group_size, archives (120, 5) and "
            f"(280, 5) for every subject; largest row norm "
            f"{max(max(n.values()) for n in norms.values()):.6f} (max-norm {EEG_BOUNDS[key]}); "
            f"on {card}")
    errs = stacked_against_serial(root, "eeg", subjects, "eeg")
    log(f"stacked == serial, eeg (S {GROUP}, 2 epochs, 280 / 120): test logits max abs err "
        f"{errs}, BatchNorm running stats within (atol, rtol) {STACK_TOL}; subject 1 against "
        f"subject 2's serial fit fails")
    errs = stacked_step_against_serial("conformer_eeg", CONFORMER_GROUP)
    log(f"stacked == serial, eeg_conformer (S {CONFORMER_GROUP}, one train step at full width, "
        f"dropout on): gradients' max abs err over the largest entry {errs} (bound {STACK_TOL[0]}), "
        f"losses within {STACK_TOL[0]} relative, running stats within {STACK_TOL}; subject 1 "
        f"against subject 2's serial step fails")
    stacked_fit_against_serial(CONFORMER_GROUP)


# -----------------------------------------------------------------------------
# 14-15. stacked train steps; the stacked AST-base
# -----------------------------------------------------------------------------


def stacked_trainer(preset):
    """A ``SubjectParallelTrainer`` of the preset's model as ``run_stacked``
    builds it (math attention and remat 'attn' for a transformer)."""
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
    from eav_tpu_torch.train.pipeline import build_model

    overrides = {}
    if preset.finetune.model in ("ast", "vit"):
        overrides = {"attn_impl": "math", "remat": "attn"}
    return SubjectParallelTrainer(build_model(preset, **overrides), preset.finetune, device="cuda")


def time_stacked_step(card: str, preset_name: str, subjects: int, what: str):
    """Median ms of 5 stacked train steps of ``subjects`` subjects on random
    inputs of the real shape (after 2 warm-up steps), its dropout masks
    drawn as in a fit -> (ms, peak GiB)."""
    import torch

    from eav_tpu_torch.core.config import get_preset

    preset = get_preset(preset_name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sp = stacked_trainer(preset)
    stack = sp.init_stack(range(subjects))
    sp.model.train()
    x, y = step_inputs(preset, (subjects,))
    for _ in range(2):
        sp.train_step(stack, x, y)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sp.train_step(stack, x, y)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"stacked train step ({what}, S {subjects}): median {ms:.2f} ms of 5, "
        f"{ms / subjects:.3f} ms a subject-step; peak memory {peak:.2f} GiB on {card}")
    return ms, peak


def run_stacked_audio(card: str) -> None:
    """``run_stacked([1, 2], "audio")`` with the full-width ``ast_finetune``
    (1 frozen + 1 unfrozen epoch, 30 train / 10 test segments), subject 2 a
    link to subject 1's wavs; the flash kernels stay idle (math attention)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import PhaseConfig, get_preset
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    base = get_preset("ast_finetune")
    preset = base.replace(
        split=dataclasses.replace(base.split, h_idx=6),
        finetune=dataclasses.replace(
            base.finetune,
            phases=(PhaseConfig(epochs=1, lr=5e-4, freeze=True),
                    PhaseConfig(epochs=1, lr=5e-6, freeze=False)),
        ),
    )
    with tempfile.TemporaryDirectory() as root:
        write_subject(root)
        os.makedirs(os.path.join(root, "subject02"))
        os.symlink(os.path.join(root, "subject01", "Audio"),
                   os.path.join(root, "subject02", "Audio"))
        pipes = ModalityPipelines(root, logits_dir=os.path.join(root, "logits"),
                                  presets={"audio": preset}, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        A.reset_launches()
        t0 = time.perf_counter()
        rows = pipes.run_stacked([1, 2], "audio")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in A.KERNELS}
        arch = [np.load(os.path.join(root, "logits", f"s0{s}_audio_{split}.npy"))
                for s in (1, 2) for split in ("test", "train")]
    m = rows[1].metrics
    hist = [rows[s].artifacts["history"]["loss"].tolist() for s in (1, 2)]
    log(f"run_stacked (audio, ast_finetune, AST-base bf16, math attention, remat 'attn', S 2, "
        f"1 frozen + 1 unfrozen epoch): {wall:.1f} s; losses {hist}, fit {m['fit_seconds']} s, "
        f"{m['samples_per_sec']} samples/s for the group; archive shapes "
        f"{[a.shape for a in arch]}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB; flash launches {launches} on {card}")
    if set(m) != METRICS_KEYS | {"group_size"} or not np.isfinite(hist).all():
        raise AssertionError(f"stacked AST rows: keys {sorted(m)}, losses {hist}")
    if [a.shape for a in arch] != [(10, 5), (30, 5)] * 2:
        raise AssertionError(f"stacked AST archives {[a.shape for a in arch]}")
    if any(launches.values()):
        raise AssertionError(f"a stacked fit launched a flash kernel: {launches}")


# -----------------------------------------------------------------------------
# 16. fusion over the stacked groups' archives
# -----------------------------------------------------------------------------


def run_fusion_phase(card: str, pipes) -> None:
    """``run_fusion`` (the ``fusion_sweep`` preset's weighted head, 100
    epochs) of EEGNet's and the conformer's archives in ``pipes``'s
    ``logits_dir`` for every subject of the stacked conformer group; the
    fused test logits must be finite."""
    import numpy as np

    t0 = time.perf_counter()
    mods = ("eeg", "eeg_conformer")
    accs = []
    for s in range(1, CONFORMER_GROUP + 1):
        res = pipes.run_fusion(s, strict=True, mods=mods)
        if set(res.metrics) != {"accuracy", "weighted_f1"}:
            raise AssertionError(f"fusion row keys {sorted(res.metrics)}")
        te = np.stack([np.load(os.path.join(pipes.logits_dir, f"s{s:02d}_{m}_test.npy"))
                       for m in mods], axis=1).astype(np.float32)
        fused = pipes._fusion_trainer(len(mods)).predict(te, res.artifacts["params"])
        if fused.shape != (120, 5) or not np.isfinite(fused).all():
            raise AssertionError(f"fused logits {fused.shape}, finite {np.isfinite(fused).all()}")
        accs.append(res.metrics["accuracy"])
    log(f"run_fusion (fusion_sweep, weighted, 100 epochs, mods {mods}) for subjects "
        f"1-{CONFORMER_GROUP}: "
        f"{time.perf_counter() - t0:.1f} s; accuracies {accs}; fused (120, 5) logits finite; "
        f"on {card}")

# -----------------------------------------------------------------------------
# 17. checkpoint import on the main path
# -----------------------------------------------------------------------------

CKPT_TOL = (1e-6, 1e-6)  # the same weights on the same card: equal up to summation order


def write_hf_checkpoints(root: str, name: str, sd: dict, formats=("safetensors", "bin")) -> dict:
    """An HF-named state dict written as ``model.safetensors`` and as
    ``pytorch_model.bin``, a directory each under ``root`` -> {format: directory}."""
    import torch

    from eav_tpu_torch.models import hf_import as H

    dirs = {}
    for fmt in formats:
        d = os.path.join(root, f"{name}-{fmt}")
        os.makedirs(d)
        if fmt == "bin":
            torch.save(sd, os.path.join(d, "pytorch_model.bin"))
        else:
            H.write_safetensors(os.path.join(d, "model.safetensors"), sd)
        dirs[fmt] = d
    return dirs


def imported_features(kind: str, ckpt_dir: str, model, x):
    """``_pretrained_params`` of ``kind`` with its variable pointed at
    ``ckpt_dir``, loaded strictly into ``model`` (on the card) -> its float32
    backbone features of ``x``."""
    import torch

    from eav_tpu_torch.train.pipeline import CKPT_ENV, _pretrained_params

    os.environ[CKPT_ENV[kind]] = ckpt_dir
    try:
        sd = _pretrained_params(kind, 5)
    finally:
        del os.environ[CKPT_ENV[kind]]
    model.load_state_dict(sd)
    with torch.no_grad():
        return model.eval()(x, mode="features")


def check_checkpoint_import(card: str, root: str) -> str:
    """Seeded AST-base and ViT-base written under HF names in both formats:
    the imported models' float32 backbone features equal the source
    weights' on the card; q and k swapped in layer 0 of the written
    checkpoint must fail that check. Returns the AST safetensors directory."""
    import copy

    import torch

    from eav_tpu_torch.models import hf_import as H
    from eav_tpu_torch.models.ast import AST
    from eav_tpu_torch.models.vit import ViT

    gen = torch.Generator(device="cuda").manual_seed(17)
    inputs = {"ast": torch.randn(2, 1024, 128, generator=gen, device="cuda"),
              "vit": torch.randn(2, 224, 224, 3, generator=gen, device="cuda")}
    out = []
    for kind, cls in (("ast", AST), ("vit", ViT)):
        t0 = time.perf_counter()
        src = cls(generator=torch.Generator().manual_seed(7)).to("cuda").eval()
        with torch.no_grad():
            want = src(inputs[kind], mode="features")
        target = copy.deepcopy(src)
        with torch.no_grad():  # nothing of the source survives but what the import loads
            for p in target.parameters():
                p.zero_()
        sd = H.to_hf_state_dict({k: v.cpu() for k, v in src.state_dict().items()}, kind)
        dirs = write_hf_checkpoints(root, kind, sd)
        errs = {fmt: max_err(imported_features(kind, d, target, inputs[kind]), want, *CKPT_TOL)
                for fmt, d in dirs.items()}
        attn = ("audio_spectrogram_transformer" if kind == "ast" else "vit") + \
            ".encoder.layer.0.attention.attention"
        q, k = f"{attn}.query.weight", f"{attn}.key.weight"
        bad = write_hf_checkpoints(root, f"{kind}-qk", {**sd, q: sd[k], k: sd[q]},
                                   ("safetensors",))["safetensors"]
        must_reject(imported_features(kind, bad, target, inputs[kind]), want, *CKPT_TOL,
                    f"{kind} checkpoint with q and k swapped in layer 0")
        out.append(f"{kind}-base {errs} ({time.perf_counter() - t0:.1f} s with the writes)")
        if kind == "ast":
            ast_dir = dirs["safetensors"]
        del src, target
    log("checkpoint import, seeded weights under HF names, float32 backbone features "
        f"against the source weights' on the card (atol, rtol {CKPT_TOL}): "
        + "; ".join(out) + f"; q and k swapped in layer 0 fails for both, on {card}")
    return ast_dir


def run_audio_from_checkpoint(card: str, ckpt_dir: str) -> dict:
    """``run_audio`` (ast_finetune, AST-base bf16, 1 frozen + 1 unfrozen
    epoch) with ``EAV_TPU_AST_CKPT`` at ``ckpt_dir``: the kernels' launches
    of the run, and the trained backbone within Adam's bound of the
    checkpoint (4 unfrozen steps at 5e-6 move an entry by about 2e-5; the
    seeded init of another seed lies ~0.02 away)."""
    from eav_tpu_torch.models import hf_import as H

    os.environ["EAV_TPU_AST_CKPT"] = ckpt_dir
    try:
        launches, res = run_main_path(with_result=True)
    finally:
        del os.environ["EAV_TPU_AST_CKPT"]
    ckpt = H.convert_ast_state_dict(H.load_state_dict_from_dir(ckpt_dir))
    params = res.artifacts["params"]
    drift = max(float((params[k] - v).abs().max()) for k, v in ckpt.items()
                if not k.startswith("classifier"))
    log(f"run_audio from the checkpoint: losses {res.artifacts['history']['loss'].tolist()}, "
        f"backbone max |trained - checkpoint| {drift:.3g} (bound 1e-4); launches {launches} "
        f"on {card}")
    if not drift <= 1e-4:
        raise AssertionError(f"the fit did not start from the checkpoint: {drift}")
    return launches


# -----------------------------------------------------------------------------
# 18. scnn_audio: the 180-d frontend and the SCNN
# -----------------------------------------------------------------------------

SCNN_TOL = 2e-4  # float32 on the card against float64 on the CPU, of a block's scale


def scnn_segments(n: int = 400, sr: int = 22050, seed: int = 18):
    """A subject's ``n`` 5 s segments at 22.05 kHz, made on the card: a
    harmonic tone (f0 100-400 Hz, random phases) under a slow envelope, plus
    noise; float32."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = torch.arange(5 * sr, device="cuda", dtype=torch.float64) / sr
    f0 = torch.as_tensor(rng.uniform(100, 400, (n, 1)), device="cuda")
    rate = torch.as_tensor(rng.uniform(0.5, 3, (n, 1)), device="cuda")
    phase = torch.as_tensor(rng.uniform(0, 2 * np.pi, (n, 4)), device="cuda")
    tone = sum(torch.sin(2 * np.pi * f0 * k * t + phase[:, k - 1 : k]) / k for k in range(1, 5))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randn(n, t.numel(), generator=gen, device="cuda", dtype=torch.float64)
    return (0.2 * (0.6 + 0.4 * torch.sin(2 * np.pi * rate * t)) * tone + 0.05 * noise).float()


def check_scnn_frontend(card: str) -> None:
    """``scnn_frontend`` on the card (float32, batch 64) against
    ``scnn180_features`` in float64 on the CPU over a subject's 400 segments:
    the tuning indices equal, each block within ``SCNN_TOL`` of its scale;
    timed (median of 3). A detuned tone recovers its tuning, and a chroma
    pinned to tuning 0 must fail against the estimated one."""
    import numpy as np
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.ingest.audio import scnn_frontend
    from eav_tpu_torch.ops import spectral as S

    cfg = get_preset("scnn_audio").audio
    segs = scnn_segments()
    host = segs.cpu().numpy()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        feats = scnn_frontend(host, cfg, device="cuda")
        times.append(time.perf_counter() - t0)
    idx_card = torch.cat([S.estimate_tuning_power(S.stft_mag_sq(segs[i : i + 64]), cfg.scnn_sr,
                                                  cfg.n_fft) for i in range(0, 400, 64)]).cpu()
    t0 = time.perf_counter()
    ref, idx_cpu = [], []
    for i in range(0, 400, 64):
        x = torch.from_numpy(host[i : i + 64]).double()
        ref.append(S.scnn180_features(x, cfg.scnn_sr).numpy())
        idx_cpu.append(S.estimate_tuning_power(S.stft_mag_sq(x), cfg.scnn_sr, cfg.n_fft))
    cpu_s = time.perf_counter() - t0
    ref, idx_cpu = np.concatenate(ref), torch.cat(idx_cpu)
    moved = torch.nonzero(idx_card != idx_cpu).flatten().tolist()
    if moved:
        raise AssertionError(f"tuning indices differ on segments {moved}")
    errs = {}
    for name, (a, b) in {"mfcc": (0, 40), "chroma": (40, 52), "mel": (52, 180)}.items():
        scale = float(np.abs(ref[:, a:b]).max())
        errs[name] = float(np.abs(feats[:, a:b] - ref[:, a:b]).max()) / scale
        if not errs[name] <= SCNN_TOL:
            raise AssertionError(f"{name} block {errs[name]:.3g} of its scale from float64")
    # a detuned harmonic A: its tuning, and the planted fault (tuning pinned to 0)
    t = torch.arange(cfg.scnn_sr, device="cuda", dtype=torch.float64) / cfg.scnn_sr
    detune = 0.3
    tone = sum(torch.sin(2 * np.pi * 220 * 2 ** (detune / 12) * k * t) / k for k in range(1, 6))
    idx = int(S.estimate_tuning_power(S.stft_mag_sq(tone.float()), cfg.scnn_sr, cfg.n_fft))
    if not abs(-0.5 + idx * 0.01 - detune) <= 0.11:
        raise AssertionError(f"detuned tone: tuning {-0.5 + idx * 0.01} for {detune}")
    est64 = S.chroma_stft(tone.cpu(), cfg.scnn_sr)
    max_err(S.chroma_stft(tone.float(), cfg.scnn_sr).cpu(), est64, 1e-4, 1e-4)
    must_reject(S.chroma_stft(tone.float(), cfg.scnn_sr, tuning=0.0).cpu(), est64, 1e-4, 1e-4,
                "chroma with the tuning pinned to 0 on a tone detuned by 0.3 bins")
    log(f"scnn180 frontend (400 segments of 5 s at 22.05 kHz, float32, batch 64): "
        f"{statistics.median(times) * 1e3:.1f} ms a subject on {card} (median of 3, host "
        f"arrays in and out), float64 CPU reference {cpu_s:.1f} s; tuning indices equal on "
        f"all 400 ({len(set(idx_cpu.tolist()))} distinct); max abs err of each block's "
        f"scale {errs} (tol {SCNN_TOL}); a tone detuned by {detune} reads "
        f"{-0.5 + idx * 0.01:.2f}, the chroma pinned to tuning 0 fails")


def run_scnn_path(card: str) -> None:
    """``run_audio(1, "scnn180")`` with the ``scnn_audio`` preset (2 of its 100
    epochs) on the synthetic audio subject of phase 5."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    base = get_preset("scnn_audio")
    preset = base.replace(
        split=dataclasses.replace(base.split, h_idx=6),  # 8 segments a class: 30 train, 10 test
        finetune=dataclasses.replace(base.finetune, phases=(
            dataclasses.replace(base.finetune.phases[0], epochs=2),)))
    with tempfile.TemporaryDirectory() as root:
        write_subject(root)
        pipes = ModalityPipelines(root, logits_dir=os.path.join(root, "logits"),
                                  presets={"audio_scnn": preset}, device="cuda")
        t0 = time.perf_counter()
        res = pipes.run_audio(1, "scnn180")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        test_arch = np.load(os.path.join(root, "logits", "s01_audio_scnn_test.npy"))
    hist, m = res.artifacts["history"], res.metrics
    log(f"run_audio(1, 'scnn180') (scnn_audio, float32, 2 epochs, 30 train / 10 test "
        f"segments): {wall:.1f} s; losses {hist['loss'].tolist()}, accuracy {m['accuracy']}, "
        f"load {m['load_seconds']} s (44.1 kHz wavs -> 22.05 kHz -> 180-d), fit "
        f"{m['fit_seconds']} s on {card}")
    if not (np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2):
        raise AssertionError(f"bad loss history {hist['loss']}")
    if set(m) != METRICS_KEYS or test_arch.shape != (10, 5):
        raise AssertionError(f"metrics keys {sorted(m)}, test archive {test_arch.shape}")


# -----------------------------------------------------------------------------
# 19. resnet_vision: ResNetAttn on the card
# -----------------------------------------------------------------------------

RESNET_TOL = 1e-4  # float32 (TF32 off), cuDNN against the CPU, of the logits' scale


def check_resnet_forward(card: str) -> None:
    """ResNetAttn's float32 eval forward at 224 x 224, batch 2, on the card
    against the CPU; the same with a sigmoid on the attention (the planted
    fault, what the reference does not do) must fail."""
    import torch

    from eav_tpu_torch.models.resnet_attn import ResNetAttn

    class SigmoidAttn(ResNetAttn):
        def attention(self, feats):
            return torch.sigmoid(super().attention(feats))

    x = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(19))
    model = ResNetAttn(generator=torch.Generator().manual_seed(19)).eval()
    fault = SigmoidAttn(generator=torch.Generator().manual_seed(19)).eval()
    with torch.no_grad():
        want, bad = model(x), fault(x)
        got = model.to("cuda")(x.to("cuda")).cpu()
    scale = float(want.abs().max())
    err = max_err(got, want, RESNET_TOL * scale, 0.0)
    must_reject(got, bad, RESNET_TOL * scale, 0.0, "a sigmoid on the channel attention")
    log(f"ResNetAttn float32 forward, 224 x 224, batch 2, card vs CPU: max abs err {err:.3g} "
        f"of logits up to {scale:.3g} (atol {RESNET_TOL} of the scale); a sigmoid on the "
        f"attention fails")


def check_resnet_import(card: str, root: str) -> str:
    """A seeded backbone saved in torchvision's layout -> ``EAV_TPU_RESNET_CKPT``
    -> ``_pretrained_params``: the imported backbone's features equal the
    source's on the card. Returns the checkpoint's path."""
    import torch

    from eav_tpu_torch.models.resnet_attn import ResNetAttn
    from eav_tpu_torch.train.pipeline import _pretrained_params

    src = ResNetAttn(generator=torch.Generator().manual_seed(3)).backbone
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():  # running stats off their init, so that their import shows
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    path = os.path.join(root, "resnet50-seeded.pth")
    torch.save(src.state_dict(), path)
    os.environ["EAV_TPU_RESNET_CKPT"] = path
    try:
        sd = _pretrained_params("resnet_attn", 5)
    finally:
        del os.environ["EAV_TPU_RESNET_CKPT"]
    model = ResNetAttn()
    model.load_state_dict(sd, strict=False)
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(6)).to("cuda")
    with torch.no_grad():
        got = model.backbone.to("cuda").eval()(x)
        want = src.to("cuda").eval()(x)
    err = max_err(got, want, *CKPT_TOL)
    log(f"torchvision-layout import of a seeded ResNet50 backbone ({len(sd)} tensors): "
        f"features max abs err {err:.3g} against the source on {card}")
    return path


def check_backbone_moved(trained: dict, src: dict, lr: float, steps: int):
    """The unfrozen phase's movement of the backbone's weights from the
    checkpoint: Adam moves an entry by about lr a step at most (x 1.25: a
    bias-corrected step can exceed lr a little), so the largest is within
    ``steps`` lr and the fit started from the checkpoint; and the median
    entry moved by at least one step's lr, so the backbone trained. Returns
    (max, median)."""
    import torch

    moved = torch.cat([(trained[k] - v).abs().flatten() for k, v in src.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))])
    top, median = float(moved.max()), float(moved.median())
    if not top <= 1.25 * steps * lr:
        raise AssertionError(f"the backbone moved {top} from the checkpoint in {steps} steps "
                             f"at lr {lr}")
    if not median >= lr:
        raise AssertionError(f"the backbone did not train: median movement {median}")
    return top, median


def run_resnet_path(card: str, ckpt: str) -> None:
    """``run_vision(1, "vision_resnet")`` (1 frozen + 1 unfrozen epoch of its
    3 + 3) from the seeded backbone checkpoint, on a synthetic frame cache of
    40 trials x 25 uint8 56 x 56 crops resized to 224 on the card. The
    frozen epoch leaves the backbone's weights and the unfrozen one moves
    them from the checkpoint (``check_backbone_moved``)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    base = get_preset("resnet_vision")
    preset = base.replace(
        split=dataclasses.replace(base.split, h_idx=6),  # 8 trials a class: 30 train, 10 test
        finetune=dataclasses.replace(base.finetune, phases=tuple(
            dataclasses.replace(p, epochs=1) for p in base.finetune.phases)))
    with tempfile.TemporaryDirectory() as root:
        cache, logits = os.path.join(root, "cache"), os.path.join(root, "logits")
        os.makedirs(cache)
        write_frame_cache(cache, preset)
        pipes = ModalityPipelines(os.path.join(root, "EAV"), cache_dir=cache, logits_dir=logits,
                                  presets={"vision_resnet": preset}, device="cuda")
        os.environ["EAV_TPU_RESNET_CKPT"] = ckpt
        try:
            t0 = time.perf_counter()
            res = pipes.run_vision(1, "vision_resnet")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            del os.environ["EAV_TPU_RESNET_CKPT"]
        test_arch = np.load(os.path.join(logits, "s01_vision_resnet_test.npy"))
    src = torch.load(ckpt, weights_only=True)
    phase = preset.finetune.phases[1]
    steps = -(-750 // preset.finetune.batch_size)
    trained = {k: res.artifacts["params"]["backbone." + k] for k in src}
    drift, median = check_backbone_moved(trained, src, phase.lr, steps)
    for what, fault in (("a backbone that stayed at the checkpoint", src),
                        ("a backbone that moved at twice the lr", {
                            k: src[k] + 2 * (trained[k] - src[k]) for k in src})):
        try:
            check_backbone_moved(fault, src, phase.lr, steps)
        except AssertionError:
            continue
        raise AssertionError(f"the check passed a planted fault: {what}")
    hist, m = res.artifacts["history"], res.metrics
    log(f"run_vision(1, 'vision_resnet') (ResNet50 + attention, float32, 1 frozen + 1 "
        f"unfrozen epoch, 750 train / 250 test frames of 30 / 10 trials at 224): {wall:.1f} s; "
        f"losses {hist['loss'].tolist()}, trial accuracy {m['accuracy']}, fit "
        f"{m['fit_seconds']} s, {m['samples_per_sec']} frames/s, load {m['load_seconds']} s; "
        f"backbone |trained - checkpoint| max {drift:.3g}, median {median:.3g} over {steps} "
        f"unfrozen steps at lr {phase.lr} (bounds: max <= {steps} lr x 1.25, median >= lr); "
        f"a backbone left at the checkpoint or moved at twice the lr fails, on {card}")
    if not (np.isfinite(hist["loss"]).all() and len(hist["loss"]) == 2):
        raise AssertionError(f"bad loss history {hist['loss']}")
    if set(m) != METRICS_KEYS or test_arch.shape != (10, 5):
        raise AssertionError(f"metrics keys {sorted(m)}, test archive {test_arch.shape}")


def main() -> int:
    import tempfile

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

    # the synthetic EEG subject is host work: written while the card runs phases 2-9
    eeg_root = tempfile.TemporaryDirectory()
    host = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    eeg_written = host.submit(timed_write_eeg_subject, eeg_root.name)
    t_start = t0 = time.perf_counter()
    build.build("flash_attention")
    log(f"build: {time.perf_counter() - t0:.1f} s")
    # the subject is written before any timed phase, so that no host work overlaps them
    log(f"synthetic EEG subject written on a host thread during the build: "
        f"{eeg_written.result():.1f} s")
    host.shutdown()
    mark("2. build")
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
    mark("3. kernels")
    check_model_and_frontend()
    mark("4. model and frontend")

    launches = run_main_path()
    mark("5. run_audio")
    time_train_step(card)
    profile_train_step(card)
    mark("6. AST step")
    # each kernel's launches from its own path: K1-K3 run_audio's, K5 the experiment's
    launches["flash_onepass"] = run_experiment(card)["flash_onepass"]
    mark("7. experiment")
    run_vision_path()
    mark("8. run_vision")
    vit_step = "ViT-base, unfrozen, bs 128, uint8 56x56 frames resized in the model, bf16"
    time_train_step(card, "vit_finetune", f"{vit_step}, math attention (the preset)")
    profile_train_step(card, "vit_finetune", top=12)
    # whether the flash kernels should serve T 197: the same step through K1-K3
    time_train_step(card, "vit_finetune", f"{vit_step}, flash kernels", attn_impl="flash")
    mark("9. ViT step")

    run_eeg_path(card, eeg_root.name)
    mark("10. run_eeg")
    serial_ms = {"eegnet_subject": eegnet_temporal_modes(card),
                 "conformer_eeg": time_train_step(
                     card, "conformer_eeg",
                     "EEG conformer (conformer_eeg), bs 32, 12 layers, embed 40, T 488, float32, "
                     "math attention, train mode")}
    profile_train_step(card, "conformer_eeg", top=12)
    mark("11. EEG steps")

    check_determinism(card, eeg_root.name)
    mark("12. determinism")
    run_stacked_eeg(card, eeg_root.name)
    mark("13. stacked EEG")
    for preset_name, sizes in (("eegnet_subject", (1, 8, 42)), ("conformer_eeg", (8, 42))):
        for size in sizes:
            ms, _ = time_stacked_step(card, preset_name, size,
                                      f"{preset_name}, bs 32 a subject, float32")
            log(f"  {preset_name} S {size}: {ms / size:.3f} ms a subject-step against the serial "
                f"step's {serial_ms[preset_name]:.3f} ms ({serial_ms[preset_name] * size / ms:.2f}x)")
    mark("14. stacked steps")
    run_stacked_audio(card)
    time_stacked_step(card, "ast_finetune", 2,
                      "AST-base, unfrozen, bs 8 a subject, bf16, math attention, remat 'attn'")
    mark("15. stacked AST")
    # fusion's host-bound head fits outside the deterministic mode
    run_fusion_phase(card, eeg_pipelines(eeg_root.name, "stacked"))
    mark("16. fusion")
    eeg_root.cleanup()

    with tempfile.TemporaryDirectory() as ckpt_root:
        ast_ckpt = check_checkpoint_import(card, ckpt_root)
        run_audio_from_checkpoint(card, ast_ckpt)
        mark("17. checkpoint import")
        check_scnn_frontend(card)
        run_scnn_path(card)
        time_train_step(card, "scnn_audio", "SCNN (scnn_audio), bs 64, 180-d features, float32")
        mark("18. scnn_audio")
        check_resnet_forward(card)
        run_resnet_path(card, check_resnet_import(card, ckpt_root))
        time_train_step(card, "resnet_vision",
                        "ResNet50 + attention (resnet_vision), unfrozen, bs 32, 224 x 224, "
                        "float32, TF32 off")
        profile_train_step(card, "resnet_vision", top=12)
        mark("19. resnet_vision")

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
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
