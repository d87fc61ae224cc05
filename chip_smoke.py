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
3b. causal kernels: K1-K3's causal mode (keys j <= i, LFM2-MoE's attention)
   at LFM2-24B-A2B's shape (B·H 128, T 8192, D 64, bf16) against the causal
   plain versions 8 heads at a time with phase 3's tolerances, a planted
   fault (the plain versions without the causal mask: an unmasked kernel)
   that the same checks must reject, the launches of those calls, and each
   kernel timed as in phase 3 beside its bound (half the FLOPs);
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
   and one unfrozen epoch: ``vmap`` with the preset's 'auto' attention
   resolved to math and remat 'attn'; the flash kernels are not launched;
   then one unfrozen stacked step at S 2 through the flash kernels' vmap
   rule (the stack folded into B·H 192) against the same step with math
   attention on the same weights: each subject's loss within
   ``STACKED_FLASH_TOL``'s relative bound and every gradient within its
   bound of the leaf's largest entry; K1 launched 24 times (12 forward, 12
   remat recompute) and K2, K3 12 times each, once a layer for the stack;
   a planted fold that interleaves the subjects must fail the check; the
   stacked step timed at S 2 with math and with flash attention, and K1-K3
   timed at the stacks' shapes (B·H 192 and 384) beside their bounds, the
   plain versions and the library's calls;
16. fusion: ``run_fusion(s, mods=("eeg", "eeg_conformer"))`` over the
   archives of phase 13 for each of the conformer group's 4 subjects at the
   preset's 100 epochs: the row keys and finite fused logits;
17. checkpoint import: seeded AST-base and ViT-base written under HF names
   (safetensors and bin) and imported (features equal, a q/k swap fails),
   and ``run_audio`` from the AST checkpoint through K1-K3;
18. scnn_audio: the scnn180 frontend on 400 segments against float64 on the
   CPU (tuning indices equal; a chroma pinned to tuning 0 fails),
   ``run_audio(1, "scnn180")`` and the SCNN step;
19. resnet_vision: ResNetAttn card vs CPU (a sigmoid on the attention
   fails), a torchvision-layout import, ``run_vision(1, "vision_resnet")``
   at 224 and the ResNet step with a profile;
20. MTCNN: ``default_face_cropper`` from seeded facenet-layout weights under
   ``EAV_TPU_MTCNN_WEIGHTS`` on a 100-frame 640x480 clip of a drawn face,
   at the preset's thresholds (random weights find nothing there) and at
   the cut ``CUT_THRESHOLDS``; the candidates after each stage per frame;
   P-, R- and O-Net card vs CPU to 1e-5, the cascade card vs CPU on every
   4th frame (boxes to 0.02 px, probabilities to 1e-5, a difference only
   where a candidate lies within 1e-5 of its threshold), the face crops
   within 1; planted faults (the pyramid without antialias, R-Net flattened
   in JAX's order) must fail; ``crop_faces_batched`` timed at 640x480 and
   480x270 (median of 3) with its split, peak memory and a profile;
21. sweep: ``SweepRunner`` over ``task_fn`` for ``eeg`` (EEGNet, 2 epochs)
   on phase 10's subject, a link to it and a subject without data, with
   prefetch and checkpoints: two done records, the third subject failed
   twice (``max_retries`` 1), a second runner finds nothing pending, the
   artifacts reload equal, ``aggregate`` equals numpy's; ``run_batched``
   over ``run_stacked`` at group size 2 bisects the group holding the
   failing subject;
22. the CLI (``eav_tpu_torch.cli.main`` in this process, so the JAX block
   and the launch counts hold): ``presets`` (and once as ``python -m
   eav_tpu_torch.cli presets``); ``verify-data --no-probe`` over eeg and
   audio (the card's machine has no video decoder) exits 0 on the data root
   and 1 on a copy with a label file that is not one-hot; ``run`` over
   eeg, eeg_conformer, audio, audio_scnn, vision and fusion for subjects
   1-3 with ``--subject-parallel 8 --chip-parallel 1 --checkpoint
   --deterministic``, epochs cut by a JSON ``--config`` and ``--set`` (AST-
   and ViT-base at full width, 1 frozen + 1 unfrozen epoch): the data root
   links phase 10's EEG subject, 100 wavs of 20 s written as phase 5 writes
   its ten (400 segments, the EEG's count, so that fusion's archives align)
   and a frame cache as phase 8's, 400 trials of 5 crops (fewer frames a
   trial, to cut time; vision reads the cache only), subjects 2-3 linked to
   subject 1. K1-K3's counts must rise; every task done, the farmed rows on
   ``cuda:0``, one farm summary, the stacked EEG, conformer and SCNN groups
   at size 3, finite fusion rows; the deterministic mode on in every
   forward and off after; subject 1's EEGNet logits equal a direct
   ``run_stacked([1, 2, 3], "eeg")`` bit for bit (the CLI stacks EEGNet); a
   second run journals nothing; ``aggregate`` equals numpy; ``run
   --profile`` writes a trace naming ``flash_fwd_wgmma``; an unknown
   ``--set`` field and ``--chip-parallel 2`` on one card are refused; the
   SCNN's stacked step at S 2, 4, 8, 16 and 42 against its serial step;
23. native ingest: ``csrc/eav_ingest.cc`` built with g++ (whether libav
   was found is printed); phase 10's ``.mat`` files read natively and by
   ``mat5``, equal; 10 wavs through ``WavPrefetcher`` and ``read_wav``,
   equal; both timed; with libav, the MP4 fixture
   (``eav_tpu_torch/fixtures``) against the cv2 frames stored beside it
   (without libav that check is reported as not made); with cv2,
   ``scripts/bench_video_decode.py`` at 4 clips of 320 x 240 (every
   variant's frame count equal), its host numbers logged; without cv2, its
   ``main`` must raise ``ImportError`` having printed nothing;
24. data parallelism: at NCCL world size 1 (this process), the full-width
   EEGNet fit with a ``data`` mesh equals the plain fit bit for bit in the
   deterministic mode; ``run_vision`` with the full-width ``vit_finetune``
   (1 + 1 epochs on phase 8's kind of cache) at world size 1, then at two
   gloo ranks on ``cuda:0`` (spawned): trial logits within ``DP_TOL``, and
   a planted fault (no gradient sum) beyond it;
25. tensor parallelism, in the same two ranks: the full-width AST-base
   unfrozen step at TP 2 (6 heads a rank) through K1-K3, whose launch
   counts rise in both ranks, against the unsharded step (``TP_LOSS_RTOL``,
   ``TP_GRAD_TOL`` of the largest gradient entry), and the contiguous-qkv
   fault beyond them; the TP step's time over gloo on one card;
26. ``parallel/dryrun.dryrun_multichip(2, "cuda")``: its legs on two gloo
   ranks on ``cuda:0`` and the farm's two workers on ``cuda:0``;
27. the measurement entry points: ``entry()`` (AST-base at batch 8, bf16,
   one forward launching K1 12 times; on a seeded normal input of its
   shape, its logits against the same module with math attention within
   ``ENTRY_TOL``, and two planted K1 faults beyond it); ``scripts/bench.py``'s three
   modes at cut sizes: the flagship (20 steps: K1, K2, K3 12 launches a
   step, MFU and roofline from the card's peaks), ``--eegnet`` (S 42, 2
   epochs, the torch EEGNet on the host's CPU live) and ``--stacked`` (S 2:
   K1 24, K2 and K3 12 a step); ``scripts/sweep_sim.py`` at 2 subjects in a
   group of 2 (200 epochs); ``scripts/run_production_sweep.py --subjects
   1-2`` in a subprocess (caches at the real shapes, ``cli run`` over eeg,
   audio, vision and fusion: every task done, the summary's modalities,
   the mean of nvidia-smi's utilization.gpu); each prints its JSON line;
28. the chip measurement scripts (``eav_tpu_torch/scripts/``): K1-K3 at
   long T against their plain versions with phase 3's tolerances and
   planted fault (T 4096 at B·H 16 in bf16 and float32, T 8192 at B·H 8 in
   bf16), then timed at those shapes and at T 16384 (B·H 8) and 32768
   (B·H 4) beside their bounds, the plain versions (where they fit) and
   the library's calls (as phases 15 and 25 time them at their shapes);
   then every ported script through its functions at full
   width with its steps cut: the audio and vision flagships and their
   repeats at 1 frozen + 1 unfrozen epoch (one repeat) on caches of the
   full protocol's shapes (K1-K3's counts must rise in the audio
   flagship; the stacked vision pair must finish), the frozen-cache
   probe at one epoch, the AST ablation and component times, the layout
   experiment (its two losses within the bf16 rtol; K1-K3's counts must
   rise), the ViT ablation, the microbenchmarks (``all``, ``vit``,
   ``flash4k --long``), the family microbench, the EEGNet stacked ablation
   at S 8 and 42, MTCNN on 10 frames a size, and the farm's replay of
   phase 27's ``metrics.jsonl``; every reading must name the card.

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
import math
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
PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores, where the f32 kernels compute
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
# The stacked AST-base step at S 2 through the flash kernels against math
# attention, same weights, bf16 (phase 15): (loss, relative; each gradient,
# of the leaf's largest entry). bf16 rounds at other points in the two paths
# (the kernels round P to V's type before P V, math keeps the softmax in
# bf16). Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 3.5e-4
# and 0.0154 (the first layer's qkv bias), the interleaving fold 0.354 and
# 20.3; the bounds sit between.
STACKED_FLASH_TOL = (1e-2, 5e-2)
# entry()'s bf16 logits through the kernels against math attention (phase
# 27): 0.0044 on its zero input and 0.0217 on the seeded normal input on
# the same card, where the planted faults read 3.32 (no 1/sqrt(D) scale)
# and 1.06 (the next sample's keys)
ENTRY_TOL = 5e-2


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


def kernel_inputs(t: int, dtype, seed: int, bh: int = B * H):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn(bh, t, D, generator=gen, device="cuda").to(dtype) for _ in range(4)
    ]


def check_kernels(t_pad: int, t: int, dtype_name: str, seed: int, bh: int = B * H,
                  onepass: bool = True) -> dict:
    """Each kernel and the autograd path against the plain versions on the
    same (``bh``, t_pad, D) inputs with ``t`` real keys, then a planted
    fault: the plain versions with the last real key masked must fail the
    same checks. K5 is checked too unless ``onepass`` is False. Returns the
    max abs errors by kernel."""
    import torch

    from eav_tpu_torch.ops import attention as A

    dtype = getattr(torch, dtype_name)
    tol, tol_lse = TOLERANCE[dtype_name]["out"], TOLERANCE[dtype_name]["lse"]
    q, k, v, do = kernel_inputs(t_pad, dtype, seed, bh)
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
    # planted fault: a mask one key short must fail every check
    o_f, lse_f = A.flash_fwd_plain(q, k, v, t - 1)
    dk_f, dv_f = A.flash_dkv_plain(q, k, v, do, lse_p, di, t - 1)
    dq_f = A.flash_dq_plain(q, k, v, do, lse_p, di, t - 1)
    faults = [(o, o_f, tol, "O"), (lse, lse_f, tol_lse, "LSE"), (dk, dk_f, tol, "dK"),
              (dv, dv_f, tol, "dV"), (dq, dq_f, tol, "dQ")]
    if onepass:
        # K5, the one-pass forward, against its own plain version
        o1_p, lse1_p = A.flash_onepass_plain(q, k, v, t)
        o1, lse1 = A.flash_onepass(q, k, v, t)
        torch.cuda.synchronize()
        errs["flash_onepass"] = max(max_err(o1, o1_p, *tol), max_err(lse1, lse1_p, *tol_lse))
        o1_f, lse1_f = A.flash_onepass_plain(q, k, v, t - 1)
        faults += [(o1, o1_f, tol, "K5 O"), (lse1, lse1_f, tol_lse, "K5 LSE")]
    for got, want, tl, what in faults:
        must_reject(got, want, *tl, f"{what} against a mask at t_real={t - 1}")
    log(f"kernels BH={bh} T={t_pad} (t_real {t}) {dtype_name}: max abs err "
        + " ".join(f"{n}={e:.3g}" for n, e in errs.items())
        + f" (atol, rtol {tol}; LSE {tol_lse}); autograd ok; a mask at t_real={t - 1} "
        "fails " + ", ".join(f[3] for f in faults))
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


def kernel_bounds(t: int, bh: int = B * H, dtype_name: str = "bfloat16",
                  causal: bool = False) -> dict:
    """Least time (ms) and what bounds it, for each kernel at (``bh``, t, D):
    matmul FLOPs at the card's peak for the type (bf16 on the tensor cores;
    the float32 kernels compute by FMA, at the float32 peak), or each
    operand read once and each output written once at the memory rate.
    ``causal``: half the FLOPs (the keys j <= i), the same bytes."""
    peak = PEAK_BF16_FLOPS if dtype_name == "bfloat16" else PEAK_F32_FLOPS
    mat = bh * t * D * (2 if dtype_name == "bfloat16" else 4)  # one (BH, T, D) operand
    row = bh * t * 4  # one float32 (BH, T) row statistic
    work = {  # (FLOP, bytes)
        "flash_fwd": (4 * t * t * D * bh, 3 * mat + mat + row),
        "flash_dkv": (8 * t * t * D * bh, 4 * mat + 2 * row + 2 * mat),
        "flash_dq": (6 * t * t * D * bh, 4 * mat + 2 * row + mat),
        "flash_onepass": (4 * t * t * D * bh, 3 * mat + mat + row),  # K1's work
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / (2 if causal else 1) / peak * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


T_LFM2, BH_LFM2 = 8192, 128  # LFM2-24B-A2B's attention: rows of 8,192 tokens, 4 x 32 heads


def check_causal_kernels(card: str, step: int = 8) -> dict:
    """Phase 3b: K1-K3's causal mode at LFM2-24B-A2B's attention shape (bf16,
    B·H 128, T 8192, D 64), the kernels over the whole batch against the
    causal plain versions ``step`` heads at a time (a plain (8, T, T)
    float32 score block is 2 GB), with phase 3's tolerances; the plain
    versions without the causal mask (an unmasked kernel) must fail the
    same checks. Then each kernel timed (one call, and a call in a run of
    20) beside its bound. Returns {kernel: {launches (of the checked calls),
    max_abs_err, ms, ms_run, bound_ms}}."""
    import torch

    from eav_tpu_torch.ops import attention as A

    bh, t = BH_LFM2, T_LFM2
    tol, tol_lse = TOLERANCE["bfloat16"]["out"], TOLERANCE["bfloat16"]["lse"]
    q, k, v, do = kernel_inputs(t, torch.bfloat16, 8192, bh)
    plain = [A.flash_fwd_plain(q[i:i + step], k[i:i + step], v[i:i + step], t, True)
             for i in range(0, bh, step)]
    o_p, lse_p = torch.cat([o for o, _ in plain]), torch.cat([lse for _, lse in plain])
    del plain
    di = (do.float() * o_p.float()).sum(-1)
    kernels = (A.flash_fwd, A.flash_dkv, A.flash_dq)
    before = [fn.launches for fn in kernels]
    o, lse = A.flash_fwd(q, k, v, t, True)
    dk, dv = A.flash_dkv(q, k, v, do, lse_p, di, t, True)
    dq = A.flash_dq(q, k, v, do, lse_p, di, t, True)
    torch.cuda.synchronize()
    out = {fn.__name__: {"launches": fn.launches - n, "max_abs_err": 0.0}
           for fn, n in zip(kernels, before)}
    if any(r["launches"] != 1 for r in out.values()):
        raise AssertionError(f"each causal kernel should have launched once: {out}")
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        args = (q[sl], k[sl], v[sl], do[sl], lse_p[sl], di[sl], t)
        dk_p, dv_p = A.flash_dkv_plain(*args, True)
        errs = {"flash_fwd": max(max_err(o[sl], o_p[sl], *tol),
                                 max_err(lse[sl], lse_p[sl], *tol_lse)),
                "flash_dkv": max(max_err(dk[sl], dk_p, *tol), max_err(dv[sl], dv_p, *tol)),
                "flash_dq": max_err(dq[sl], A.flash_dq_plain(*args, True), *tol)}
        for n, e in errs.items():
            out[n]["max_abs_err"] = max(out[n]["max_abs_err"], e)
    # planted fault: attention without the causal mask must fail every check
    sl = slice(0, step)
    args = (q[sl], k[sl], v[sl], do[sl], lse_p[sl], di[sl], t)
    o_f, lse_f = A.flash_fwd_plain(q[sl], k[sl], v[sl], t)
    dk_f, dv_f = A.flash_dkv_plain(*args)
    for got, want, tl, what in ((o[sl], o_f, tol, "O"), (lse[sl], lse_f, tol_lse, "LSE"),
                                (dk[sl], dk_f, tol, "dK"), (dv[sl], dv_f, tol, "dV"),
                                (dq[sl], A.flash_dq_plain(*args), tol, "dQ")):
        must_reject(got, want, *tl, f"causal {what} against attention without the causal mask")
    calls = {"flash_fwd": lambda: A.flash_fwd(q, k, v, t, True),
             "flash_dkv": lambda: A.flash_dkv(q, k, v, do, lse_p, di, t, True),
             "flash_dq": lambda: A.flash_dq(q, k, v, do, lse_p, di, t, True)}
    bounds = kernel_bounds(t, bh, causal=True)
    for n, fn in calls.items():
        out[n].update(ms=cuda_ms(fn), ms_run=cuda_ms_run(fn), bound_ms=bounds[n][0])
    log(f"causal kernels BH={bh} T={t} D={D} bf16: " + "; ".join(
        f"{n} max abs err {r['max_abs_err']:.3g}, {r['launches']} launch(es), {r['ms']:.3f} ms "
        f"one call, {r['ms_run']:.3f} ms a call in a run of 20, bound {r['bound_ms']:.4f} ms"
        for n, r in out.items())
        + f" (atol, rtol {tol}; LSE {tol_lse}); without the causal mask O, LSE, dK, dV, dQ "
        f"fail on {card}")
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


def stacked_trainer(preset, attn_impl: str = "math"):
    """A ``SubjectParallelTrainer`` of the preset's model as ``run_stacked``
    builds it (remat 'attn' for a transformer, with ``attn_impl``: math, as
    the presets' 'auto' resolves in a stack, or flash)."""
    from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
    from eav_tpu_torch.train.pipeline import build_model

    overrides = {}
    if preset.finetune.model in ("ast", "vit"):
        overrides = {"attn_impl": attn_impl, "remat": "attn"}
    return SubjectParallelTrainer(build_model(preset, **overrides), preset.finetune, device="cuda")


def time_stacked_step(card: str, preset_name: str, subjects: int, what: str,
                      attn_impl: str = "math"):
    """Median ms of 5 stacked train steps of ``subjects`` subjects on random
    inputs of the real shape (after 2 warm-up steps), its dropout masks
    drawn as in a fit -> (ms, peak GiB)."""
    import torch

    from eav_tpu_torch.core.config import get_preset

    preset = get_preset(preset_name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sp = stacked_trainer(preset, attn_impl)
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


def interleaved_fold(x, dim, size: int):
    """A planted fault for ``ops/attention._fold``: the stack folded B·H-major
    ((BH, S) order), while the outputs are read back subject-major."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.transpose(0, 1).reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def stacked_ast_step(attn_impl: str, x, y):
    """One unfrozen stacked ``ast_finetune`` step of S subjects (seeds 0..S-1)
    -> (loss (S,), gradients by leaf, launches of K1-K3 in the step). The
    trainer's first step at a shape finds the model's dropouts by one
    unbatched forward (``_masks``); it runs before the count."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.ops import attention as A

    sp = stacked_trainer(get_preset("ast_finetune"), attn_impl)
    stack = sp.init_stack(range(x.shape[0]))
    sp.model.train()
    sp._masks(stack, x, "full")
    before = {fn.__name__: fn.launches for fn in A.KERNELS[:3]}
    loss, _ = sp.train_step(stack, x, y)
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in A.KERNELS[:3]}
    return loss.float(), {k: p.grad.float() for k, p in stack.params.items()}, launched


def stacked_flash_error(flash, math) -> tuple:
    """(largest relative loss difference, largest gradient difference in
    units of its leaf's largest entry, the leaf) of two stacked steps."""
    (loss_f, grads_f, _), (loss_m, grads_m, _) = flash, math
    loss_err = float(((loss_f - loss_m).abs() / loss_m.abs()).max())
    name, grad_err = max(((k, float((grads_f[k] - g).abs().max() / g.abs().max().clamp_min(1e-30)))
                          for k, g in grads_m.items()), key=lambda kv: kv[1])
    return loss_err, grad_err, name


def check_stacked_flash(card: str) -> None:
    """The stacked AST-base step at S 2 through the flash kernels' vmap rule
    against math attention on the same weights and batch, its launches, and
    the interleaving fold that must fail."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.ops import attention as A

    x, y = step_inputs(get_preset("ast_finetune"), (2,))
    math = stacked_ast_step("math", x, y)
    flash = stacked_ast_step("flash", x, y)
    loss_err, grad_err, leaf = stacked_flash_error(flash, math)
    log(f"stacked AST-base step, S 2, bf16, remat 'attn': flash (B·H {2 * B * H} a launch) vs "
        f"math attention, losses {flash[0].tolist()} vs {math[0].tolist()}: relative loss diff "
        f"{loss_err:.3g}, gradients {grad_err:.3g} of the leaf's largest entry (worst: {leaf}); "
        f"tolerance {STACKED_FLASH_TOL}; launches in the step {flash[2]} on {card}")
    if flash[2] != {"flash_fwd": 24, "flash_dkv": 12, "flash_dq": 12}:
        raise AssertionError(f"the stacked step launched {flash[2]}, not K1 24, K2 12, K3 12")
    if not (loss_err <= STACKED_FLASH_TOL[0] and grad_err <= STACKED_FLASH_TOL[1]):
        raise AssertionError(f"stacked flash step off math: loss {loss_err}, gradients {grad_err}")
    fold = A._fold
    A._fold = interleaved_fold
    try:
        bad = stacked_ast_step("flash", x, y)
    finally:
        A._fold = fold
    bad_loss, bad_grad, bad_leaf = stacked_flash_error(bad, math)
    log(f"planted interleaving fold: relative loss diff {bad_loss:.3g}, gradients {bad_grad:.3g} "
        f"(worst: {bad_leaf})")
    if bad_loss <= STACKED_FLASH_TOL[0] and bad_grad <= STACKED_FLASH_TOL[1]:
        raise AssertionError("the stacked flash check passed a fold that interleaves subjects")
    del math, flash, bad
    torch.cuda.empty_cache()


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


# -----------------------------------------------------------------------------
# 20. MTCNN on the card
# -----------------------------------------------------------------------------

MTCNN_TOL = 1e-5  # the nets' outputs and the probabilities, card against the CPU
BOX_TOL = 0.02  # px, the boxes, card against the CPU
# Random weights leave stage 1 empty at the preset's (0.6, 0.7, 0.7) and
# flood it at the JAX tests' (0.2, 0.05, 0.05), where nearly every position
# passes (the phase prints both). The checks and the timings run where
# 60-90 candidates a frame pass stage 1 and about half pass each later stage.
CUT_THRESHOLDS = (0.5, 0.5, 0.35)


def mtcnn_state_dicts(seed: int = 20) -> list:
    """facenet-layout P/R/O-Net state dicts: fan-in-scaled normals from a
    numpy seed, the PReLU slopes at 0.25 scale."""
    import numpy as np
    import torch

    from eav_tpu_torch.models import mtcnn

    rng = np.random.default_rng(seed)
    out = []
    for cls in (mtcnn.PNet, mtcnn.RNet, mtcnn.ONet):
        sd = {}
        for k, v in cls().state_dict().items():
            scale = 1.0 / np.sqrt(np.prod(v.shape[1:])) if v.ndim >= 2 else 0.25
            sd[k] = torch.from_numpy((rng.standard_normal(tuple(v.shape)) * scale).astype(np.float32))
        out.append(sd)
    return out


def synthetic_face_image(h: int, w: int):
    """A frontal face drawn with numpy (scripts/convert_mtcnn.py's fixture):
    shaded head ellipse, eyes, brows, nose and mouth on a dark ground."""
    import numpy as np

    img = np.full((h, w, 3), 60, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h * 0.5, w * 0.5
    d = ((yy - cy) / (h * 0.36)) ** 2 + ((xx - cx) / (w * 0.27)) ** 2
    face = d < 1.0
    shade = np.clip(1.0 - 0.25 * d, 0.0, 1.0)
    skin = np.stack([224 * shade, 182 * shade, 152 * shade], axis=-1)
    img[face] = skin[face].astype(np.uint8)

    def blob(y, x, ry, rx, color):
        img[((yy - y) / ry) ** 2 + ((xx - x) / rx) ** 2 < 1.0] = color

    for sx in (-1, 1):
        ex, ey = cx + sx * w * 0.11, cy - h * 0.08
        blob(ey, ex, h * 0.035, w * 0.055, (250, 250, 250))  # sclera
        blob(ey, ex, h * 0.025, w * 0.030, (80, 50, 30))  # iris
        blob(ey, ex, h * 0.012, w * 0.014, (10, 10, 10))  # pupil
        blob(ey - h * 0.06, ex, h * 0.012, w * 0.06, (60, 40, 30))  # brow
    blob(cy + h * 0.03, cx, h * 0.045, w * 0.020, (196, 144, 118))  # nose
    blob(cy + h * 0.14, cx, h * 0.025, w * 0.085, (150, 60, 60))  # mouth
    return img


def face_clip(n: int = 100, h: int = 480, w: int = 640):
    """A clip of ``n`` (h, w) RGB frames (every 6th of 6n), a face of 5/8 the
    frame's height drifting across it."""
    import numpy as np

    fh, fw = 5 * h // 8, 5 * w // 8
    face = synthetic_face_image(fh, fw)
    frames = np.full((n, h, w, 3), 60, np.uint8)
    for i in range(n):
        y0 = (h - fh) // 2 + int((h - fh) // 3 * np.sin(i / 7))
        x0 = (i * 3) % (w - fw)
        frames[i, y0 : y0 + fh, x0 : x0 + fw] = face
    return frames


def _unmatched(a, b):
    """Rows of candidate arrays (n, 5) ``a`` with no row of ``b`` within the
    box and probability tolerances."""
    import numpy as np

    if len(b) == 0:
        return a
    close = ((np.abs(a[:, None, :4] - b[None, :, :4]).max(-1) <= BOX_TOL)
             & (np.abs(a[:, None, 4] - b[None, :, 4]) <= MTCNN_TOL))
    return a[~close.any(1)]


def compare_cascades(card_stages, cpu_stages, thresholds) -> list:
    """Each frame's candidates after each stage, card against CPU. A frame
    whose lists differ is explained only by a candidate, present on one side
    only at the first stage that differs, whose probability lies within
    MTCNN_TOL of that stage's threshold: roundoff flipped it. Returns
    (frame, stage, distance) of the explained frames; raises otherwise."""
    import numpy as np

    explained = []
    for f in range(len(card_stages[0])):
        for k, thr in enumerate(thresholds):
            a, b = card_stages[k][f], cpu_stages[k][f]
            lone = np.concatenate([_unmatched(a, b), _unmatched(b, a)])
            if len(lone) == 0:
                continue
            dist = float(np.abs(lone[:, 4] - thr).min())
            if dist >= MTCNN_TOL:
                raise AssertionError(
                    f"frame {f}: stage {k + 1} candidates differ, card {len(a)} / CPU {len(b)}, "
                    f"nearest to the threshold {thr} by {dist:.3g} (>= {MTCNN_TOL})")
            explained.append((f, k + 1, dist))
            break
    return explained


def must_differ(card_stages, cpu_stages, thresholds, what: str) -> None:
    try:
        compare_cascades(card_stages, cpu_stages, thresholds)
    except AssertionError:
        return
    raise AssertionError(f"the check passed a planted fault: {what}")


def check_mtcnn_nets(det, cpu_det, frames, cpu_stage1):
    """P-, R- and O-Net on the card against the CPU on the same inputs: the
    pyramid's first scale of two frames, and the 24 / 48 crops of up to 256
    stage-1 candidates -> (max abs err, input shape) by net. R-Net
    flattened in the JAX package's order must fail."""
    import numpy as np
    import torch

    from eav_tpu_torch.models import mtcnn
    from eav_tpu_torch.ops.image import resize_bilinear

    _, hs, ws = cpu_det._pyramid(*frames.shape[1:3])[0]
    fcpu = torch.as_tensor(frames)
    idx, sq = cpu_det._flatten(cpu_stage1, *frames.shape[1:3])
    idx, sq = idx[:256], sq[:256]
    inputs = {
        "pnet": cpu_det._nchw(resize_bilinear(fcpu[:2].float(), hs, ws)),
        "rnet": cpu_det._nchw(cpu_det._gather_crops(fcpu, idx, sq, 24)),
        "onet": cpu_det._nchw(cpu_det._gather_crops(fcpu, idx, sq, 48)),
    }
    errs = {}
    with torch.no_grad():
        for name, x in inputs.items():
            want = getattr(cpu_det, name)(x)
            got = getattr(det, name)(x.cuda())
            errs[name] = max(max_err(g.cpu(), w, MTCNN_TOL, 0.0) for g, w in zip(got, want))

        class JaxOrderRNet(mtcnn.RNet):  # the planted fault: Flax's (C, H, W) flatten
            def forward(self, x):
                x = torch.nn.functional.max_pool2d(self.prelu1(self.conv1(x)), 3, 2, ceil_mode=True)
                x = torch.nn.functional.max_pool2d(self.prelu2(self.conv2(x)), 3, 2, ceil_mode=True)
                x = self.prelu3(self.conv3(x))
                x = self.prelu4(self.dense4(x.reshape(x.shape[0], -1)))
                return self.dense5_1(x).softmax(1), self.dense5_2(x)

        fault = JaxOrderRNet().cuda().eval()
        fault.load_state_dict(det.rnet.state_dict())
        got = fault(inputs["rnet"].cuda())
        want = cpu_det.rnet(inputs["rnet"])
        must_reject(got[1].cpu(), want[1], MTCNN_TOL, 0.0, "R-Net flattened in JAX's order")
    return errs, {k: tuple(v.shape) for k, v in inputs.items()}


class StageClock:
    """Milliseconds of ``det``'s P-Net pyramid calls and its crop calls
    (gather, R-Net and O-Net, and the final crops), each ending in a copy to
    the host, so the host clock reads the device's work; the rest of a call
    is host NMS and box math."""

    def __init__(self, det):
        self.det, self.ms = det, {"pyramid": 0.0, "crops": 0.0}

    def __enter__(self):
        for name, key in (("_pnet_scaled", "pyramid"), ("_crops_chunked", "crops")):
            setattr(self.det, name, self._timed(getattr(self.det, name), key))
        return self

    def __exit__(self, *exc):
        del self.det._pnet_scaled, self.det._crops_chunked

    def _timed(self, fn, key):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.ms[key] += (time.perf_counter() - t0) * 1e3
            return out
        return call


def time_face_crops(card: str, det, h: int, w: int, n: int = 100) -> None:
    """frames/s of ``crop_faces_batched`` on an ``n``-frame h x w clip, the
    median of 3, with the split of the median run, peak memory and one
    profiled run for the device's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frames = face_clip(n, h, w)
    det.crop_faces_batched(frames)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(3):
        with StageClock(det) as clock:
            t0 = time.perf_counter()
            det.crop_faces_batched(frames)
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
        runs.append((total, clock.ms["pyramid"], clock.ms["crops"]))
    total, pyr, crops = sorted(runs)[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det.crop_faces_batched(frames)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    log(f"crop_faces_batched, {n} frames {w}x{h}, thresholds {det.thresholds}: "
        f"{n / total * 1e3:.1f} frames/s ({total:.1f} ms, runs {[round(r[0], 1) for r in runs]}): "
        f"P-Net pyramid {pyr:.1f} ms, host NMS and box math {total - pyr - crops:.1f} ms, "
        f"R/O-Net and gather {crops:.1f} ms; peak {peak:.2f} GiB; profiled run {wall:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / wall:.1f}%) on {card}")


def run_mtcnn_phase(card: str) -> None:
    """MTCNN on the card: ``default_face_cropper`` from seeded weights under
    ``EAV_TPU_MTCNN_WEIGHTS``, held against the port on the CPU on the same
    weights, with two planted faults, then timed."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.models import mtcnn

    sds = mtcnn_state_dicts()
    preset_cfg = get_preset("vit_finetune").vision
    cfg = dataclasses.replace(preset_cfg, mtcnn_thresholds=CUT_THRESHOLDS)
    frames = face_clip()
    with tempfile.TemporaryDirectory() as weights:
        for net, sd in zip(mtcnn.NETS, sds):
            torch.save(sd, os.path.join(weights, f"{net}.pt"))
        os.environ["EAV_TPU_MTCNN_WEIGHTS"] = weights
        try:
            cropper = mtcnn.default_face_cropper(cfg, "cuda")
            preset_cropper = mtcnn.default_face_cropper(preset_cfg, "cuda")
        finally:
            del os.environ["EAV_TPU_MTCNN_WEIGHTS"]
    det = cropper.func.__self__
    cpu_det = mtcnn.MTCNNDetector(*sds, thresholds=CUT_THRESHOLDS, device="cpu")

    # the main path: the clip through the cropper, at the cut and at the preset
    t0 = time.perf_counter()
    crops = cropper(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = det.cascade_batched(frames)
    hits = sum(len(c) > 0 for c in stages[2])
    preset_stages = preset_cropper.func.__self__.cascade_batched(frames)
    preset_crops = preset_cropper(frames)
    def counts(st) -> str:
        return " | ".join(" ".join(str(len(c)) for c in s) for s in st)

    log(f"MTCNN (default_face_cropper, {len(frames)} frames {frames.shape[2]}x{frames.shape[1]}, "
        f"seeded facenet-layout "
        f"weights): {wall:.2f} s for the clip at the cut thresholds {CUT_THRESHOLDS}, crops "
        f"{crops.shape} {crops.dtype}, {hits} frames with a face")
    log(f"  candidates per frame after stages 1 / 2 / 3 at {CUT_THRESHOLDS}: {counts(stages)}")
    log(f"  at the preset's {preset_cfg.mtcnn_thresholds}: {counts(preset_stages)}")
    if crops.shape != (100, 56, 56, 3) or preset_crops.shape != (100, 56, 56, 3) or hits == 0:
        raise AssertionError(f"crops {crops.shape}, {preset_crops.shape}, {hits} hits")
    flood = mtcnn.MTCNNDetector(*sds, thresholds=(0.2, 0.05, 0.05), device="cuda")
    t0 = time.perf_counter()
    flood_stages = flood.cascade_batched(frames[:1])
    log(f"  at the JAX tests' (0.2, 0.05, 0.05), one frame: {counts(flood_stages)} in "
        f"{time.perf_counter() - t0:.1f} s (the host's NMS over the flood)")

    # card against CPU, every 4th frame
    sub = frames[::4]
    t0 = time.perf_counter()
    cpu_stages = cpu_det.cascade_batched(sub)
    cpu_s = time.perf_counter() - t0
    errs, shapes = check_mtcnn_nets(det, cpu_det, sub, cpu_stages[0])
    log(f"  P-, R- and O-Net card vs CPU on inputs {shapes}: max abs err {errs} "
        f"(atol {MTCNN_TOL}); R-Net flattened in JAX's order fails")
    card_stages = det.cascade_batched(sub)
    explained = compare_cascades(card_stages, cpu_stages, CUT_THRESHOLDS)
    same = [f for f in range(len(sub)) if f not in {e[0] for e in explained}]
    card_crops, cpu_crops = det.crop_faces_batched(sub), cpu_det.crop_faces_batched(sub)
    crop_err = int(np.abs(card_crops[same].astype(int) - cpu_crops[same].astype(int)).max())
    if crop_err > 1:
        raise AssertionError(f"face crops card vs CPU differ by {crop_err} > 1")
    log(f"  cascade card vs CPU on {len(sub)} frames (CPU {cpu_s:.1f} s): every stage's "
        f"candidates within {BOX_TOL} px and {MTCNN_TOL} except {len(explained)} frames, each "
        f"explained by a candidate this close to its threshold (frame, stage, distance): "
        f"{explained}; face crops of the other {len(same)} frames within {crop_err} (<= 1)")
    orig = mtcnn.resize_bilinear

    def interpolate(x, height, width):  # the planted fault: no antialias
        return torch.nn.functional.interpolate(
            x.permute(0, 3, 1, 2), (height, width), mode="bilinear", antialias=False,
            align_corners=False).permute(0, 2, 3, 1)

    mtcnn.resize_bilinear = interpolate
    try:
        fault_stages = det.cascade_batched(sub)
    finally:
        mtcnn.resize_bilinear = orig
    must_differ(fault_stages, cpu_stages, CUT_THRESHOLDS,
                "the pyramid through F.interpolate(antialias=False)")
    log("  the pyramid through F.interpolate(antialias=False) fails the cascade check")

    time_face_crops(card, det, 480, 640)
    time_face_crops(card, det, 270, 480)


# -----------------------------------------------------------------------------
# 21. the sweep on the card
# -----------------------------------------------------------------------------

def run_sweep_phase(card: str, eeg_root: str) -> None:
    """``SweepRunner`` over ``task_fn('eeg')`` (EEGNet, full width, 2 epochs)
    for phase 10's subject, a link to it and a subject with no data, with
    per-task checkpoints and the pipelines' prefetch; then ``run_batched``
    over ``run_stacked`` at group size 2 with the failing subject in a
    group; ``aggregate`` against numpy."""
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.core.checkpoint import load_pytree
    from eav_tpu_torch.core.config import SweepConfig
    from eav_tpu_torch.core.sweep import SweepRunner, _read_jsonl
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    src = os.path.join(eeg_root, "EAV", "subject01", "EEG")
    with tempfile.TemporaryDirectory() as root:
        for s in (1, 2, 4):  # subject 3 has no data
            edir = os.path.join(root, "EAV", f"subject{s:02d}", "EEG")
            os.makedirs(edir)
            for suffix in ("eeg.mat", "eeg_label.mat"):
                os.symlink(os.path.join(src, f"subject01_{suffix}"),
                           os.path.join(edir, f"subject{s:02d}_{suffix}"))
        pipes = ModalityPipelines(os.path.join(root, "EAV"), cache_dir=os.path.join(root, "cache"),
                                  presets=eeg_presets(), device="cuda")
        results = {}

        def task(subject, modality):
            results[subject] = pipes.task_fn(subject, modality)
            return results[subject]

        cfg = SweepConfig(subjects=(1, 2, 3), modalities=("eeg",), max_retries=1,
                          journal_path=os.path.join(root, "journal.jsonl"),
                          metrics_path=os.path.join(root, "metrics.jsonl"),
                          checkpoint_dir=os.path.join(root, "ckpt"))
        runner = SweepRunner(cfg, task)
        t0 = time.perf_counter()
        runner.run(verbose=False, prefetch_fn=pipes.prefetch)
        runner.run(verbose=False, prefetch_fn=pipes.prefetch)  # the retry of subject 3
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        journal = _read_jsonl(cfg.journal_path)
        got = [(r["task"], r["status"], r["attempts"]) for r in journal]
        want = [("subject01_eeg", "done", 1), ("subject02_eeg", "done", 1),
                ("subject03_eeg", "failed", 1), ("subject03_eeg", "failed", 2)]
        if got != want or SweepRunner(cfg, task).pending_tasks():
            raise AssertionError(f"journal {got}, pending {SweepRunner(cfg, task).pending_tasks()}")
        for s in (1, 2):
            saved = load_pytree(os.path.join(cfg.checkpoint_dir, f"subject{s:02d}_eeg"))
            art = results[s].artifacts
            for group in ("params", "history"):
                for k, v in art[group].items():
                    if not np.array_equal(saved[group][k], np.asarray(v)):
                        raise AssertionError(f"subject {s} {group}/{k} reloads unequal")
        rows = _read_jsonl(cfg.metrics_path)
        if {k for r in rows for k in r} != METRICS_KEYS | {"subject", "modality", "wall_clock_s"}:
            raise AssertionError(f"metrics keys {sorted({k for r in rows for k in r})}")
        agg = runner.aggregate()["eeg"]
        acc = [r["accuracy"] for r in rows]
        if (agg["n_subjects"], agg["mean_accuracy"], agg["std_accuracy"]) != (
                2, float(np.mean(acc[::-1])), float(np.std(acc[::-1]))):
            raise AssertionError(f"aggregate {agg} against numpy over {acc}")
        log(f"SweepRunner (task_fn 'eeg', EEGNet full width, 2 epochs, prefetch, checkpoints): "
            f"{wall:.1f} s; journal {got}; seconds a task "
            f"{[r.get('wall_clock_s') for r in journal]}; a second runner finds nothing "
            f"pending; the saved params and histories reload equal; aggregate {agg} on {card}")

        cfg2 = SweepConfig(subjects=(1, 2, 3, 4), modalities=("eeg",), max_retries=0,
                           journal_path=os.path.join(root, "journal2.jsonl"),
                           metrics_path=os.path.join(root, "metrics2.jsonl"))
        t0 = time.perf_counter()
        state = SweepRunner(cfg2, task).run_batched(
            "eeg", lambda group: pipes.run_stacked(group, "eeg"), group_size=2, verbose=False)
        wall = time.perf_counter() - t0
        status = {t: (r["status"], "stacked_error" in r) for t, r in sorted(state.items())}
        rows = _read_jsonl(cfg2.metrics_path)
        want = {"subject01_eeg": ("done", False), "subject02_eeg": ("done", False),
                "subject03_eeg": ("failed", True), "subject04_eeg": ("done", False)}
        keys = {k for r in rows for k in r}
        if status != want or keys != METRICS_KEYS | {"subject", "modality", "wall_clock_s",
                                                     "group_size"}:
            raise AssertionError(f"run_batched: {status}, metrics keys {sorted(keys)}")
        log(f"run_batched('eeg', run_stacked, group size 2) over subjects 1-4: {wall:.1f} s; "
            f"{status} (the group [3, 4] bisected, subject 3 failed after its serial "
            f"fallback); group sizes {[r['group_size'] for r in rows]}; seconds a task "
            f"{[r['wall_clock_s'] for r in rows]}")


# -----------------------------------------------------------------------------
# 22. the CLI: python -m eav_tpu_torch.cli on the card
# -----------------------------------------------------------------------------

CLI_SUBJECTS = "1-3"
CLI_DEVICE = "cuda:0"  # the farm's one worker
CLI_TRACED = "flash_fwd_wgmma"  # K1's kernel, which --profile's trace must name
# epochs cut through a --config file (JSON: the card's machine has no
# PyYAML) and --set; vision keeps 5 frames a trial (below)
CLI_CONFIG = {
    "eeg": {"finetune": {"phases": {"0": {"epochs": 2}}}},
    "eeg_conformer": {"finetune": {"phases": {"0": {"epochs": 2}}}},
    "audio_scnn": {"finetune": {"phases": {"0": {"epochs": 2}}}},
    "vision": {"vision": {"frames_per_sample": 5}, "finetune": {"vote_group": 5}},
    "fusion": {"finetune": {"phases": {"0": {"epochs": 20}}}},
}
CLI_SET = ["audio.finetune.phases.0.epochs=1", "audio.finetune.phases.1.epochs=1",
           "vision.finetune.phases.0.epochs=1", "vision.finetune.phases.1.epochs=1"]


def cli_call(argv) -> tuple:
    """``eav_tpu_torch.cli.main(argv)`` in this process -> (rc, its stdout)."""
    import contextlib
    import io

    from eav_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    return rc, out.getvalue()


def cli_must_fail(argv, what: str) -> str:
    """Raises unless the CLI refuses ``argv`` (a non-zero exit or an error)."""
    try:
        rc, _ = cli_call(argv)
    except SystemExit as e:
        if e.code in (0, None):
            raise AssertionError(f"{what}: exited 0") from None
        return f"exit {str(e.code)[:60]!r}"
    except Exception as e:  # noqa: BLE001 — the refusal is the expected result
        return f"{type(e).__name__}: {str(e)[:60]}"
    if rc == 0:
        raise AssertionError(f"the CLI accepted {what}")
    return f"rc {rc}"


def cli_data_root(root: str, eeg_root: str, presets) -> None:
    """``root``/EAV and ``root``/cache for the CLI: phase 10's EEG subject
    (links to its .mat files), 100 wavs of 20 s as phase 5 writes them (400
    segments, as many as the EEG's chunks, so that fusion aligns), subjects
    2-3 links to subject 1; and phase 8's kind of frame cache under the
    vision preset's key, 400 trials of 5 56x56 crops (subject 1's, linked
    for 2-3). The card's machine has no video decoder, so vision reads the
    cache only; the EAV tree holds no Video folder."""
    from eav_tpu_torch.train.pipeline import _cfg_hash

    eav, cache = os.path.join(root, "EAV"), os.path.join(root, "cache")
    os.makedirs(cache)
    src = os.path.join(eeg_root, "EAV", "subject01", "EEG")
    for s in (1, 2, 3):
        name = f"subject{s:02d}"
        os.makedirs(os.path.join(eav, name, "EEG"))
        for suffix in ("eeg.mat", "eeg_label.mat"):
            os.symlink(os.path.join(src, f"subject01_{suffix}"),
                       os.path.join(eav, name, "EEG", f"{name}_{suffix}"))
        if s > 1:
            os.symlink(os.path.join(eav, "subject01", "Audio"), os.path.join(eav, name, "Audio"))
    write_subject(eav, 1, files=100)
    write_frame_cache(cache, presets["vision"], 1, trials=400)
    key = _cfg_hash(presets["vision"].vision)
    for s in (2, 3):
        os.symlink(os.path.join(cache, f"s01_vis_{key}.npz"),
                   os.path.join(cache, f"s{s:02d}_vis_{key}.npz"))


def run_cli_phase(card: str, eeg_root: str, scnn_serial_ms: float) -> None:
    """The port's CLI driven in this process (``eav_tpu_torch.cli.main``):
    ``presets`` (and once as ``python -m``), ``verify-data --no-probe``
    (clean root 0, a corrupted label file 1), the sweep with the farm of one
    worker, a second run that finds nothing pending, ``aggregate`` against
    numpy, and the refusals; then the SCNN's stacked step at S 2 to 42 for
    its stack cap."""
    import argparse
    import tempfile

    import numpy as np
    import torch

    from eav_tpu_torch.cli import _presets
    from eav_tpu_torch.core.config import SweepConfig
    from eav_tpu_torch.core.sweep import SweepRunner, _read_jsonl
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.train.pipeline import ModalityPipelines, default_presets

    t_phase = time.perf_counter()
    rc, out = cli_call(["presets"])
    proc = subprocess.run([sys.executable, "-m", "eav_tpu_torch.cli", "presets"], cwd=HERE,
                          capture_output=True, text=True, timeout=300)
    for text, how in ((out, "in process"), (proc.stdout, "python -m")):
        listed = {line.split()[0] for line in text.splitlines() if line.strip()}
        if not set(default_presets()) <= listed:
            raise AssertionError(f"presets ({how}) lists {sorted(listed)}")
    if rc != 0 or proc.returncode != 0:
        raise AssertionError(f"presets exited {rc} / {proc.returncode}: {proc.stderr[-500:]}")

    with tempfile.TemporaryDirectory() as root:
        cfg_path = os.path.join(root, "overrides.json")
        with open(cfg_path, "w") as f:
            json.dump(CLI_CONFIG, f)
        overrides = ["--config", cfg_path] + [a for kv in CLI_SET for a in ("--set", kv)]
        presets = _presets(argparse.Namespace(config=cfg_path, set=CLI_SET))
        t0 = time.perf_counter()
        cli_data_root(root, eeg_root, presets)
        eav, cache, out_dir = (os.path.join(root, d) for d in ("EAV", "cache", "out"))
        log(f"CLI data root (EEG links, 100 wavs of 20 s, a 400 x 5 frame cache, subjects 2-3 "
            f"linked): {time.perf_counter() - t0:.1f} s")

        vd = ["verify-data", "--data-root", eav, "--subjects", CLI_SUBJECTS,
              "--modalities", "eeg,audio", "--no-probe"]
        rc_clean, _ = cli_call(vd)
        bad = os.path.join(root, "EAV_bad")
        os.makedirs(os.path.join(bad, "subject01", "EEG"))
        for name in ("subject02", "subject03"):
            os.symlink(os.path.join(eav, name), os.path.join(bad, name))
        os.symlink(os.path.join(eav, "subject01", "Audio"), os.path.join(bad, "subject01", "Audio"))
        os.symlink(os.path.join(eav, "subject01", "EEG", "subject01_eeg.mat"),
                   os.path.join(bad, "subject01", "EEG", "subject01_eeg.mat"))
        from eav_tpu_torch.ingest import mat5

        label = mat5.loadmat(os.path.join(eav, "subject01", "EEG", "subject01_eeg_label.mat"))
        label = label["label"].copy()
        label[:, 0] = 0  # trial 0 is no longer one-hot
        mat5.savemat(os.path.join(bad, "subject01", "EEG", "subject01_eeg_label.mat"),
                     {"label": label})
        rc_bad, bad_out = cli_call(["verify-data", "--data-root", bad, *vd[3:]])
        if (rc_clean, rc_bad) != (0, 1) or "one-hot" not in bad_out:
            raise AssertionError(f"verify-data exits {rc_clean} (clean), {rc_bad} (corrupted)")

        run = ["run", "--data-root", eav, "--subjects", CLI_SUBJECTS, "--modalities",
               "eeg,eeg_conformer,audio,audio_scnn,vision,fusion", "--out", out_dir,
               "--cache-dir", cache, "--subject-parallel", "8", "--chip-parallel", "1",
               "--checkpoint", "--deterministic", *overrides]
        flags = []
        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            lambda m, a: flags.append(torch.are_deterministic_algorithms_enabled()))
        A.reset_launches()
        t0 = time.perf_counter()
        try:
            rc, _ = cli_call(run)
            torch.cuda.synchronize()
        finally:
            hook.remove()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in (A.flash_fwd, A.flash_dkv, A.flash_dq)}
        if rc != 0 or not all(n > 0 for n in launches.values()):
            raise AssertionError(f"cli run exited {rc}; launches of K1-K3 {launches}")
        if not (flags and all(flags)) or torch.are_deterministic_algorithms_enabled():
            raise AssertionError(f"the deterministic mode: {sum(flags)} of {len(flags)} forwards "
                                 f"on, {torch.are_deterministic_algorithms_enabled()} after")
        cfg = SweepConfig(journal_path=os.path.join(out_dir, "journal.jsonl"),
                          metrics_path=os.path.join(out_dir, "metrics.jsonl"),
                          subjects=(1, 2, 3), modalities=(
                              "eeg", "eeg_conformer", "audio", "audio_scnn", "vision", "fusion"))
        runner = SweepRunner(cfg, None)
        state, rows = runner.journal_state(), _read_jsonl(cfg.metrics_path)
        if len(state) != 18 or any(r["status"] != "done" for r in state.values()):
            raise AssertionError(f"journal: {[(t, r['status']) for t, r in state.items()]}")
        farmed = [r for r in rows if r.get("modality") in ("audio", "vision")]
        if len(farmed) != 6 or any(r.get("device") != CLI_DEVICE for r in farmed):
            raise AssertionError(f"farmed rows' devices {[r.get('device') for r in farmed]}")
        summary = [r for r in rows if r.get("event") == "farm_summary"]
        groups = {r["modality"]: r.get("group_size") for r in rows
                  if r.get("modality") in ("eeg", "eeg_conformer", "audio_scnn")}
        fusion = [r for r in rows if r.get("modality") == "fusion"]
        if len(summary) != 1 or summary[0]["n_tasks"] != 6 or set(groups.values()) != {3}:
            raise AssertionError(f"farm summary {summary}, stacked group sizes {groups}")
        if len(fusion) != 3 or not all(np.isfinite([r["accuracy"], r["weighted_f1"]]).all()
                                       for r in fusion):
            raise AssertionError(f"fusion rows {fusion}")
        log(f"cli run (eeg, eeg_conformer, audio_scnn stacked at S 3; audio: ast_finetune "
            f"AST-base bf16 and vision: vit_finetune ViT-base, each 1 frozen + 1 unfrozen "
            f"epoch, farmed on {CLI_DEVICE}; fusion; subjects {CLI_SUBJECTS}, 280 train / 120 test "
            f"a modality, --deterministic --checkpoint): {wall:.1f} s; farm makespan "
            f"{summary[0]['makespan_s']} s, busy {summary[0]['busy_s']} s over "
            f"{summary[0]['n_tasks']} farmed tasks; seconds a task "
            f"{ {r['task'][10:]: r['wall_clock_s'] for r in state.values() if r['task'][:9] == 'subject01'} }; "
            f"launches {launches}; the deterministic mode on in {len(flags)} forwards and off "
            f"after; fusion accuracy {[r['accuracy'] for r in fusion]} on {card}")

        # the CLI adds orchestration, not math: the stacked EEGNet group it ran
        direct = ModalityPipelines(eav, cache_dir=cache, logits_dir=os.path.join(root, "direct"),
                                   presets=presets, device="cuda", deterministic=True)
        direct.run_stacked([1, 2, 3], "eeg")
        for split in ("train", "test"):
            got = np.load(os.path.join(out_dir, "logits", f"s01_eeg_{split}.npy"))
            want = np.load(os.path.join(root, "direct", f"s01_eeg_{split}.npy"))
            if not np.array_equal(got, want):
                raise AssertionError(f"subject 1's EEGNet {split} logits differ from a direct "
                                     f"run_stacked: max {np.abs(got - want).max()}")

        n_journal = len(_read_jsonl(cfg.journal_path))
        if runner.pending_tasks():
            raise AssertionError(f"pending after the run: {runner.pending_tasks()}")
        rc, _ = cli_call(run)
        if rc != 0 or len(_read_jsonl(cfg.journal_path)) != n_journal:
            raise AssertionError("a second run journaled new records")

        rc, agg_out = cli_call(["aggregate", "--out", out_dir])
        printed = json.loads(agg_out[agg_out.index("{"):])
        latest = {}
        for r in rows:
            if r.get("accuracy") is not None:
                latest[(r["subject"], r["modality"])] = r
        for mod, d in printed.items():
            acc = [r["accuracy"] for (s, m), r in sorted(latest.items()) if m == mod]
            if (d != runner.aggregate()[mod] or d["n_subjects"] != 3
                    or not np.isclose(d["mean_accuracy"], np.mean(acc), rtol=1e-12, atol=0)
                    or not np.isclose(d["std_accuracy"], np.std(acc), rtol=1e-12, atol=1e-15)):
                raise AssertionError(f"aggregate {mod}: {d} against numpy over {acc}")
        log("cli: presets (in process and python -m), verify-data --no-probe (clean 0, a "
            "corrupted label file 1), subject 1's EEGNet logits equal a direct "
            "run_stacked([1, 2, 3]) bit for bit, a second run journals nothing, aggregate "
            f"equals numpy over {len(printed)} modalities")

        prof_root, trace_dir = os.path.join(root, "prof"), os.path.join(root, "trace")
        write_subject(os.path.join(prof_root, "EAV"))
        t0 = time.perf_counter()
        rc, _ = cli_call(["run", "--data-root", os.path.join(prof_root, "EAV"), "--subjects", "1",
                          "--modalities", "audio", "--out", os.path.join(prof_root, "out"),
                          "--profile", trace_dir, "--set", "audio.split.h_idx=6", *overrides])
        traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
        named = any(CLI_TRACED in open(os.path.join(trace_dir, t)).read() for t in traces)
        if rc != 0 or not named:
            raise AssertionError(f"--profile: rc {rc}, traces {traces}, {CLI_TRACED} named: "
                                 f"{named}")
        size = sum(os.path.getsize(os.path.join(trace_dir, t)) for t in traces)
        refusals = [
            cli_must_fail([*run[:8], os.path.join(root, "x"), "--set",
                           "eeg.split.no_such_field=1"], "an unknown field"),
            cli_must_fail([*run[:8], os.path.join(root, "y"), "--chip-parallel", "2"],
                          "--chip-parallel 2 on one card"),
        ]
        log(f"cli run --profile (audio, subject 1, 30 / 10 segments): "
            f"{time.perf_counter() - t0:.1f} s, a {size / 2**20:.1f} MiB Chrome trace naming "
            f"{CLI_TRACED}; refused: an unknown --set field ({refusals[0]}), "
            f"--chip-parallel 2 ({refusals[1]})")

    for size in (2, 4, 8, 16, 42):  # the SCNN's stack cap (cli._STACK_CAPS)
        ms, _ = time_stacked_step(card, "scnn_audio", size, "scnn_audio, bs 64 a subject, float32")
        log(f"  scnn_audio S {size}: {ms / size:.3f} ms a subject-step against the serial "
            f"step's {scnn_serial_ms:.3f} ms ({scnn_serial_ms * size / ms:.2f}x)")
    log(f"phase 22: {time.perf_counter() - t_phase:.1f} s")


# -----------------------------------------------------------------------------
# 23. the native ingest library
# -----------------------------------------------------------------------------


def run_native_phase(card: str, eeg_root: str) -> None:
    """``csrc/eav_ingest.cc`` built with g++ (libav when ``pkg-config`` finds
    it); phase 10's ``.mat`` files and phase 5's kind of wavs read natively
    and by the pure-Python readers, equal, both timed; with libav, the MP4
    fixture decoded against the cv2 frames stored beside it."""
    import tempfile

    import numpy as np

    from eav_tpu_torch.ingest import mat5, native
    from eav_tpu_torch.ingest.wav import read_wav
    from eav_tpu_torch.ops import build
    from eav_tpu_torch.scripts.make_video_fixture import FIXTURES, FRAMES, STRIDE

    host = f"the host of {card}"
    lib = build.library_path("eav_ingest")
    built = lib.exists()  # the audio ingest of phase 5 builds it at first use
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("no g++: the native ingest library cannot be built")
    how = ("built with g++ at its first use (phase 5's audio ingest)" if built
           else f"built with g++ in {time.perf_counter() - t0:.2f} s")
    libav = native.mp4_supported()
    log(f"native ingest: {lib.name} {how} on {host}; "
        f"libav {'found: the MP4 decoder is built' if libav else 'NOT found by pkg-config'}")
    edir = os.path.join(eeg_root, "EAV", "subject01", "EEG")
    for name, var in (("subject01_eeg.mat", "seg"), ("subject01_eeg_label.mat", "label")):
        path = os.path.join(edir, name)
        t0 = time.perf_counter()
        got = native.read_mat_var(path, var)
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = mat5.loadmat(path)[var]
        t_python = time.perf_counter() - t0
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"{name}: native {got.shape} != mat5 {want.shape}")
        log(f"  {name} '{var}' {got.shape}: native {t_native * 1e3:.1f} ms, mat5 "
            f"{t_python * 1e3:.1f} ms, equal, on {host}")
    with tempfile.TemporaryDirectory() as root:
        write_subject(root)
        adir = os.path.join(root, "subject01", "Audio")
        files = sorted(os.path.join(adir, f) for f in os.listdir(adir))
        t0 = time.perf_counter()
        with native.WavPrefetcher(n_threads=4) as pf:
            for f in files:
                pf.submit(f)
            got = {path: (wave, sr) for path, wave, sr in pf}
        t_native = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = {f: read_wav(f) for f in files}
        t_python = time.perf_counter() - t0
        for f in files:
            if got[f][1] != want[f][1] or not np.array_equal(got[f][0], want[f][0]):
                raise AssertionError(f"{f}: the prefetcher's decode differs from read_wav's")
        log(f"  {len(files)} wavs of 20 s at 44.1 kHz: WavPrefetcher (4 threads) "
            f"{t_native * 1e3:.1f} ms, read_wav {t_python * 1e3:.1f} ms, equal, on {host}")
    check_video_decode_bench(host)
    if not libav:
        log("  MP4: NOT checked: this machine has no ffmpeg development files, so the native "
            "decoder is not built; native video decoding on it waits for them")
        return
    t0 = time.perf_counter()
    frames = native.read_mp4_strided(str(FIXTURES / "clip.mp4"), STRIDE, FRAMES)
    t_native = time.perf_counter() - t0
    ref = np.load(FIXTURES / "clip_frames.npz")["frames"]
    diff = np.abs(frames.astype(int) - ref.astype(int))
    if frames.shape != ref.shape or diff.mean() >= 1.0 or np.percentile(diff, 99) > 4:
        raise AssertionError(f"MP4 fixture: {frames.shape} against cv2's {ref.shape}, mean "
                             f"|diff| {diff.mean() if diff.size else 'n/a'}")
    log(f"  MP4 fixture {frames.shape}: native {t_native * 1e3:.1f} ms, against cv2's frames "
        f"mean |diff| {diff.mean():.3f}, max {diff.max()}, on {host}")


def check_video_decode_bench(host: str) -> None:
    """``scripts/bench_video_decode.py`` on this machine's host. With cv2, its
    ``main`` at 4 clips of 320 x 240 (it raises unless every variant decodes
    the same frame count), its lines logged; without cv2, ``main`` must raise
    ``ImportError`` having printed nothing."""
    import contextlib
    import io

    from eav_tpu_torch.scripts import bench_video_decode

    argv = ["--clips", "4", "--wh", "320x240"]
    out = io.StringIO()
    try:
        import cv2
    except ImportError:
        with contextlib.redirect_stdout(out):
            try:
                bench_video_decode.main(argv)
            except ImportError:
                pass
            else:
                raise AssertionError("bench_video_decode.main ran without cv2")
        if out.getvalue():
            raise AssertionError(f"bench_video_decode printed without cv2: {out.getvalue()!r}")
        log(f"  bench_video_decode: no cv2 on {host}, so main raised ImportError and printed "
            "nothing; host-side decode timing waits for a decoder on this machine")
        return
    log(f"  bench_video_decode: cv2 {cv2.__version__} on {host}")
    with contextlib.redirect_stdout(out):
        lines = bench_video_decode.main(argv)
    variants = [line["variant"] for line in lines]
    if variants[:2] != ["reference_serial", "grab_serial"] or variants[-1] != "threaded":
        raise AssertionError(f"bench_video_decode printed the variants {variants}")
    for line in lines:
        log(f"  bench_video_decode on {host}: {json.dumps(line)}")


# -----------------------------------------------------------------------------
# 24-25. data and tensor parallelism on the card
# -----------------------------------------------------------------------------

# Measured on the card (PERF.md §6): bf16 products of half batches and
# of head shards round differently from the whole ones.
# Vision at 2 gloo ranks against world 1, max |trial logit diff|: sound
# 0.0074, the planted fault (no gradient sum) 0.40-1.09.
DP_TOL = 0.05
# The AST-base step at TP 2 against the unsharded one: sound loss 2.6e-3
# relative and gradients 0.0078 of the largest entry; the contiguous-qkv
# fault 2.1e-2 and 0.83.
TP_LOSS_RTOL = 1e-2
TP_GRAD_TOL = 0.05  # of the unsharded gradient's largest entry


def dp_vision_preset():
    """Phase 8's ``vit_finetune`` cut: 1 frozen + 1 unfrozen epoch, 30 train
    / 10 test trials of 25 frames."""
    import dataclasses

    from eav_tpu_torch.core.config import PhaseConfig, get_preset

    base = get_preset("vit_finetune")
    return base.replace(
        split=dataclasses.replace(base.split, h_idx=6),
        finetune=dataclasses.replace(
            base.finetune, phases=(PhaseConfig(epochs=1, lr=5e-4, freeze=True),
                                   PhaseConfig(epochs=1, lr=5e-6, freeze=False))))


def dp_vision_fit(root: str, logits: str, mesh):
    """``run_vision(1)`` over phase 8's kind of frame cache under ``root``
    with ``mesh`` -> (trial-voted test and train archives, losses, seconds)
    on the rank that writes (None elsewhere)."""
    import numpy as np
    import torch

    from eav_tpu_torch.parallel.distributed import rank_device
    from eav_tpu_torch.train.loop import writes_files
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    pipes = ModalityPipelines(os.path.join(root, "EAV"), cache_dir=os.path.join(root, "cache"),
                              logits_dir=os.path.join(root, logits),
                              presets={"vision": dp_vision_preset()},
                              device=rank_device("cuda"), mesh=mesh)
    t0 = time.perf_counter()
    res = pipes.run_vision(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not writes_files():
        return None
    arch = {s: np.load(os.path.join(root, logits, f"s01_vision_{s}.npy")) for s in ("test", "train")}
    return arch, res.artifacts["history"]["loss"].tolist(), wall


def tp_step(model, x, y):
    """Loss and gradients of one train-mode step."""
    import torch

    from eav_tpu_torch.train.loop import cross_entropy

    model.train()
    loss = cross_entropy(model(x), y)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}


def tp_error(grads, ref, rank: int, size: int, contiguous: bool = False) -> float:
    """Max over leaves of |this rank's gradient - its shard of the unsharded
    one| / the unsharded gradient's largest entry."""
    from eav_tpu_torch.parallel import tp

    scale = max(float(g.abs().max()) for g in ref.values())
    worst = 0.0
    for k, g in grads.items():
        spec = tp.tp_spec(k)
        if contiguous and spec is not None and "qkv" in k:
            spec = (0, 1)
        want = ref[k] if spec is None else tp.shard_tensor(ref[k], spec, rank, size)
        worst = max(worst, float((g.float() - want.float()).abs().max()) / scale)
    return worst


def multi_card_rank(rank: int, root: str) -> dict:
    """One of two gloo ranks on ``cuda:0``: the vision fine-tune
    data-parallel over both, sound and with a planted fault (no gradient
    sum: each rank steps on its own rows' gradient); then the full-width
    AST-base unfrozen step tensor-parallel over both (6 heads a rank,
    through K1-K3), against the unsharded step on the same rank, and the
    contiguous-qkv fault."""
    import torch

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.parallel import tp
    from eav_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
    from eav_tpu_torch.train.loop import DataShards
    from eav_tpu_torch.train.pipeline import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    mesh = make_mesh(((DATA_AXIS, 2),), "cuda")
    out["dp"] = dp_vision_fit(root, "dp2", mesh)
    summed = DataShards.sum_grads_
    DataShards.sum_grads_ = lambda self, model: None  # the planted fault
    try:
        out["dp_fault"] = dp_vision_fit(root, "dp2_fault", mesh)
    finally:
        DataShards.sum_grads_ = summed

    preset = get_preset("ast_finetune")
    x, y = step_inputs(preset)
    full = build_model(preset).to("cuda")
    ref_loss, ref = tp_step(full, x, y)
    mesh2 = make_mesh(((MODEL_AXIS, 2),), "cuda")
    model = tp.apply_tp(build_model(preset).to("cuda"), mesh2)
    A.reset_launches()
    loss, grads = tp_step(model, x, y)
    launches = {fn.__name__: fn.launches for fn in (A.flash_fwd, A.flash_dkv, A.flash_dq)}
    times = []
    for _ in range(5):
        model.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        tp_step(model, x, y)
        times.append((time.perf_counter() - t0) * 1e3)
    out["tp"] = {"loss": loss, "ref_loss": ref_loss, "err": tp_error(grads, ref, rank, 2),
                 "launches": launches, "heads": model.encoder.layer_0.attn.heads,
                 "step_ms": statistics.median(times)}
    rules = tp._RULES
    tp._RULES = tuple((rx, (0, 1) if "qkv" in rx else spec) for rx, spec in rules)
    try:
        bad = tp.apply_tp(build_model(preset).to("cuda"), mesh2)
        bad_loss, bad_grads = tp_step(bad, x, y)
        out["tp_fault"] = {"loss": bad_loss,
                           "err": tp_error(bad_grads, ref, rank, 2, contiguous=True)}
    finally:
        tp._RULES = rules
    return out


def run_multi_card_phases(card: str, eeg_root: str) -> None:
    """24: the EEGNet fit data-parallel at world size 1 over NCCL equals the
    plain fit bit for bit (the deterministic mode); the vision fine-tune at
    world size 1, then at two gloo ranks on ``cuda:0`` against it (and a
    planted fault). 25: the tensor-parallel AST-base step (in the same two
    ranks)."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from eav_tpu_torch.parallel import distributed
    from eav_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
    from eav_tpu_torch.train.loop import Trainer
    from eav_tpu_torch.train.pipeline import build_model

    preset = eeg_presets()["eeg"]
    rng = np.random.default_rng(24)
    data = (rng.standard_normal((280, 30, 500)).astype(np.float32), np.arange(280) % 5,
            rng.standard_normal((120, 30, 500)).astype(np.float32), np.arange(120) % 5)
    with tempfile.TemporaryDirectory() as root:
        os.makedirs(os.path.join(root, "cache"))
        write_frame_cache(os.path.join(root, "cache"), dp_vision_preset())
        distributed.init_multihost(f"127.0.0.1:{distributed.free_port()}", 1, 0, device="cuda")
        try:
            mesh = make_mesh(((DATA_AXIS, 1),), "cuda")
            fits, secs = {}, {}
            for name, m in (("plain", None), ("nccl", mesh)):
                trainer = Trainer(build_model(preset), preset.finetune, device="cuda",
                                  deterministic=True)
                t0 = time.perf_counter()
                fits[name] = trainer.fit(data, seed=1, mesh=m)
                torch.cuda.synchronize()
                secs[name] = time.perf_counter() - t0
            same = np.array_equal(fits["plain"].outputs_test, fits["nccl"].outputs_test) and all(
                torch.equal(v, fits["nccl"].params[k]) for k, v in fits["plain"].params.items())
            log(f"data-parallel EEGNet (eegnet_subject, 2 epochs, 280 / 120 trials) at NCCL "
                f"world 1: {'equal to' if same else 'DIFFERS from'} the plain fit bit for bit "
                f"(logits, weights, BatchNorm stats); {secs['nccl']:.2f} s against "
                f"{secs['plain']:.2f} s (the first collective sets NCCL up) on {card}")
            if not same:
                raise AssertionError("the data-parallel fit at world 1 differs from the plain fit")
            ref, ref_loss, ref_s = dp_vision_fit(root, "world1", mesh)
        finally:
            dist.destroy_process_group()
        mark("24a. data parallelism at NCCL world 1")
        t0 = time.perf_counter()
        ranks = distributed.spawn(multi_card_rank, 2, root, device="cuda:0", backend="gloo",
                                  timeout_s=600)
        spawn_s = time.perf_counter() - t0
    (arch, loss, wall), (bad, bad_loss, _) = ranks[0]["dp"], ranks[0]["dp_fault"]
    err = {s: float(np.abs(arch[s] - ref[s]).max()) for s in ref}
    bad_err = {s: float(np.abs(bad[s] - ref[s]).max()) for s in ref}
    log(f"data-parallel run_vision (vit_finetune, ViT-base bf16, 750 train / 250 test frames, "
        f"1 + 1 epochs) at 2 gloo ranks on cuda:0 against world 1: max |trial logit diff| "
        f"test {err['test']:.3g}, train {err['train']:.3g} (tolerance {DP_TOL}); losses "
        f"{loss} against {ref_loss}; planted fault (no gradient sum) {bad_err} "
        f"(losses {bad_loss}); {wall:.1f} s against {ref_s:.1f} s at world 1 (gloo on one "
        f"card: a fact of this check, not a speed of data parallelism) on {card}")
    if max(err.values()) > DP_TOL:
        raise AssertionError(f"data-parallel vision beyond {DP_TOL}: {err}")
    if max(bad_err.values()) <= DP_TOL:
        raise AssertionError(f"the check passed the planted fault: {bad_err}")
    mark("24b. data parallelism at 2 gloo ranks")
    for rank, r in enumerate(ranks):
        t, f = r["tp"], r["tp_fault"]
        log(f"tensor-parallel AST-base step (ast_finetune, bs 8, bf16, unfrozen) rank {rank} "
            f"of 2 ({t['heads']} heads a rank): loss {t['loss']:.5f} against unsharded "
            f"{t['ref_loss']:.5f}; max |grad diff| {t['err']:.3g} of the largest entry "
            f"(tolerance loss rtol {TP_LOSS_RTOL}, grads {TP_GRAD_TOL}); contiguous-qkv fault "
            f"loss {f['loss']:.5f}, grads {f['err']:.3g}; launches {t['launches']} at B*H "
            f"{8 * t['heads']}; step {t['step_ms']:.1f} ms (gloo on one card: a fact of this "
            f"check, not a speed of TP) on {card}")
        if not all(n > 0 for n in t["launches"].values()):
            raise AssertionError(f"rank {rank}: a flash kernel never launched: {t['launches']}")
        if abs(t["loss"] - t["ref_loss"]) > TP_LOSS_RTOL * abs(t["ref_loss"]) \
                or t["err"] > TP_GRAD_TOL:
            raise AssertionError(f"rank {rank}: the TP step differs from the unsharded one")
        if abs(f["loss"] - t["ref_loss"]) <= TP_LOSS_RTOL * abs(t["ref_loss"]) \
                and f["err"] <= TP_GRAD_TOL:
            raise AssertionError(f"rank {rank}: the check passed the contiguous-qkv fault")
    log(f"the two gloo ranks on cuda:0 (DP vision twice, TP step): {spawn_s:.1f} s from the "
        f"spawn on {card}")
    time_kernels_at(card, 8 * ranks[0]["tp"]["heads"], "a TP rank's shape")
    mark("25. tensor parallelism")


# -----------------------------------------------------------------------------
# 27. the measurement entry points
# -----------------------------------------------------------------------------


def check_entry(card: str) -> None:
    """``entry()``: one forward of AST-base at batch 8 on its zero input
    through K1 (finite logits, 12 launches); then the same module through K1
    and through math attention on a seeded normal input of that shape,
    whose rows and tokens differ, within ``ENTRY_TOL``, and two planted K1
    faults (the 1/sqrt(D) scale dropped; each sample's queries against the
    next sample's keys and values) beyond it."""
    import torch

    from eav_tpu_torch.entry import entry
    from eav_tpu_torch.models.transformer import MultiHeadSelfAttention
    from eav_tpu_torch.ops import attention as A

    forward, (model, x) = entry()
    forward(model, x)  # warm
    torch.cuda.synchronize()
    before = A.flash_fwd.launches
    t0 = time.perf_counter()
    out = forward(model, x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launched = A.flash_fwd.launches - before
    if out.shape != (8, 5) or not bool(torch.isfinite(out).all()) or launched != 12:
        raise AssertionError(f"entry(): logits {tuple(out.shape)}, K1 launched {launched}")
    gen = torch.Generator(device="cuda").manual_seed(27)
    xr = torch.randn(x.shape, generator=gen, device="cuda")
    got = forward(model, xr)
    fwd = A.FlashAttention.forward  # K1 through its counted wrapper, as the faults call it
    faults = {"no 1/sqrt(D) scale":
              lambda q, k, v, t, causal=False: fwd(q * q.shape[-1] ** 0.5, k, v, t, causal),
              "keys of the next sample":
              lambda q, k, v, t, causal=False: fwd(q, k.roll(H, 0), v.roll(H, 0), t, causal)}
    bad = {}
    for what, fault in faults.items():
        A.FlashAttention.forward = staticmethod(fault)
        try:
            bad[what] = forward(model, xr)
        finally:
            A.FlashAttention.forward = staticmethod(fwd)
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.attn_impl = "math"
    want = forward(model, xr)
    err = max_err(got, want, ENTRY_TOL, ENTRY_TOL)
    log(f"entry(): AST-base bf16 forward at batch 8, logits {tuple(out.shape)}, {ms:.2f} ms, K1 "
        f"launched {launched} times; on a seeded normal input, max abs err against math "
        f"attention {err:.3g} (atol = rtol = {ENTRY_TOL}), planted faults " + ", ".join(
            f"{what} {float((b.float() - want.float()).abs().max()):.3g}"
            for what, b in bad.items()) + f" on {card}")
    for what, b in bad.items():
        must_reject(b, want, ENTRY_TOL, ENTRY_TOL, f"entry(): {what}")


def check_bench_line(line: dict, launches: dict, name: str) -> None:
    if not (line["value"] > 0 and name in line["device"]):
        raise AssertionError(f"bench line: {line}")
    if launches and line["launches_per_step"] != launches:
        raise AssertionError(f"bench launches a step {line['launches_per_step']}, not {launches}")


def run_measurement_phase(card: str) -> str:
    """Phase 27: ``entry()``, the bench's three modes, ``sweep_sim`` and the
    production sweep at cut sizes, each printing its JSON line -> the
    sweep's ``metrics.jsonl``."""
    import tempfile

    import torch

    from eav_tpu_torch.scripts import bench, sweep_sim

    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    check_entry(card)
    line = bench.main(["--steps", "20"])
    check_bench_line(line, {"flash_fwd": 12, "flash_dkv": 12, "flash_dq": 12}, name)
    if line["mfu_pct"] is None or line["roofline_pct"] is None:
        raise AssertionError("the flagship line has no MFU or roofline on the card")
    check_bench_line(bench.main(["--eegnet", "--epochs", "2"]), {}, name)
    stack = os.environ.get("EAV_BENCH_STACK")
    os.environ["EAV_BENCH_STACK"] = "2"
    try:
        line = bench.main(["--stacked"])
    finally:
        if stack is None:
            del os.environ["EAV_BENCH_STACK"]
        else:
            os.environ["EAV_BENCH_STACK"] = stack
    check_bench_line(line, {"flash_fwd": 24, "flash_dkv": 12, "flash_dq": 12}, name)
    log(f"entry() and the bench's three modes: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    line = sweep_sim.main(["2", "2"])
    if not (line["epochs"] == 200 and line["value"] > 0 and name in line["device"]):
        raise AssertionError(f"sweep_sim: {line}")
    log(f"sweep_sim at 2 subjects: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "eav_tpu_torch.scripts.run_production_sweep", "--subjects",
             "1-2", "--out", out], cwd=HERE, capture_output=True, text=True, timeout=900)
        wall = time.perf_counter() - t0
        log(run.stdout.strip())
        if run.returncode != 0:
            raise AssertionError(f"run_production_sweep exited {run.returncode}: "
                                 f"{run.stderr[-3000:]}")
        with open(os.path.join(out, "journal.jsonl")) as f:
            done = {r["task"] for r in map(json.loads, f) if r.get("status") == "done"}
        with open(os.path.join(out, "metrics.jsonl")) as f:
            metrics = f.read()  # phase 28 replays it through the farm
        summary = json.loads(run.stdout[run.stdout.index('{\n  "sweep_journal_summary"'):])
    want = {f"subject0{s}_{m}" for s in (1, 2) for m in ("eeg", "audio", "vision", "fusion")}
    report = summary["sweep_journal_summary"]
    log(f"run_production_sweep --subjects 1-2: {wall:.1f} s, {len(done)} tasks done on {card}")
    if done != want or set(report) != {"eeg", "audio", "vision", "fusion", "total"}:
        raise AssertionError(f"production sweep: done {sorted(done)}, summary {sorted(report)}")
    if report["total"].get("gpu_util_pct") is None or name not in summary["device"]:
        raise AssertionError(f"production sweep summary without the card: {summary}")
    return metrics


def time_kernels_at(card: str, bh: int, what: str, t: int = T_AST) -> dict:
    """K1-K3 at (``bh``, ``t``, D 64, bf16) on the free card: a call in a run
    of 20 beside its bound, the plain version's call (None where it runs out
    of device memory) and the library's (SDPA's forward; aten's flash
    backward, dQ, dK and dV in one call) in a run of 20, at ``what``: a TP
    rank's B·H/2, a stack's S·B·H, a long T."""
    import torch
    import torch.nn.functional as F

    from eav_tpu_torch.ops import attention as A

    q, k, v, do = kernel_inputs(t, torch.bfloat16, 40, bh)
    o, lse = A.flash_fwd(q, k, v, t)
    di = (do.float() * o.float()).sum(-1)
    calls = {"flash_fwd": (lambda: A.flash_fwd(q, k, v, t),
                           lambda: A.flash_fwd_plain(q, k, v, t)),
             "flash_dkv": (lambda: A.flash_dkv(q, k, v, do, lse, di, t),
                           lambda: A.flash_dkv_plain(q, k, v, do, lse, di, t)),
             "flash_dq": (lambda: A.flash_dq(q, k, v, do, lse, di, t),
                          lambda: A.flash_dq_plain(q, k, v, do, lse, di, t))}
    q4, k4, v4, do4 = (x.view(1, bh, t, D) for x in (q, k, v, do))
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(q4, k4, v4)

    def aten_bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            do4, q4, k4, v4, *fwd[:6], 0.0, False, fwd[6], fwd[7])[0]

    library = {"flash_fwd": cuda_ms_run(lambda: F.scaled_dot_product_attention(q4, k4, v4))}
    library["flash_dkv"] = library["flash_dq"] = cuda_ms_run(aten_bwd)
    bounds = kernel_bounds(t, bh)
    row = {"t": t, "bh": bh}
    for n, (fn, plain) in calls.items():
        try:
            plain_ms = cuda_ms(plain, reps=3, warmup=1)
        except torch.cuda.OutOfMemoryError:
            plain_ms = None
        torch.cuda.empty_cache()
        row[n] = {"ms_run": cuda_ms_run(fn), "plain_ms": plain_ms, "library_ms_run": library[n],
                  "bound_ms": bounds[n][0], "bound_by": bounds[n][1]}
    log(f"K1-K3 at {what} (BH {bh}, T {t}, D {D}, bf16), a call in a run of 20: " + ", ".join(
        f"{n} {r['ms_run']:.4f} ms (bound {r['bound_ms']:.4f} by {r['bound_by']}, plain "
        + (f"{r['plain_ms']:.3f}" if r["plain_ms"] is not None else "out of memory")
        + f", library {r['library_ms_run']:.4f})" for n, r in row.items() if n.startswith("flash"))
        + f" on {card}")
    return row


# -----------------------------------------------------------------------------
# 28. the chip measurement scripts
# -----------------------------------------------------------------------------

# K1-K3 at long T against their plain versions, (T, B·H, type), with phase
# 3's tolerances and planted fault: the shapes of scripts/microbench.py's
# flash4k (T 4096 at B 2, H 8; T 8192 at B 1, H 8)
LONG_T_CHECKS = ((4096, 16, "bfloat16"), (4096, 16, "float32"), (8192, 8, "bfloat16"))
# and timed in bf16 there and at --long's T 16384 (B 1, H 8) and 32768 (B 1, H 4)
LONG_T_TIMED = ((4096, 16), (8192, 8), (16384, 8), (32768, 4))
CUT_EPOCHS = (1, 1)  # the flagships' frozen and unfrozen epochs in phase 28


def check_lines(lines: list, name: str, what: str) -> list:
    """Every reading of a script names the card; raises otherwise."""
    if not lines:
        raise AssertionError(f"{what}: no reading")
    for line in lines:
        text = json.dumps(line)
        if name not in text:
            raise AssertionError(f"{what}: a reading without the card: {text[:300]}")
    return lines


def run_scripts_phase(card: str, sweep_metrics: str) -> None:
    """Phase 28: K1-K3 at long T, then every ported chip measurement script
    at full width with its steps cut, each printing its JSON readings."""
    import tempfile

    import torch

    from eav_tpu_torch.ops import attention as A
    from eav_tpu_torch.scripts import (
        ast_ablation,
        ast_component_times,
        bench,
        eegnet_stacked_ablation,
        family_microbench,
        farm_makespan,
        flash_layout_experiment,
        measure_audio_flagship,
        measure_audio_repeats,
        measure_mtcnn,
        measure_vision_flagship,
        measure_vision_repeats,
        microbench,
        probe_frozen_cache,
        vit_ablation,
    )

    name = torch.cuda.get_device_name(0)
    clock = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        clock[what] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    for i, (t, bh, dt) in enumerate(LONG_T_CHECKS):
        check_kernels(t, t, dt, seed=30 + i, bh=bh, onepass=False)
        torch.cuda.empty_cache()
    rows = [time_kernels_at(card, bh, f"T {t}", t) for t, bh in LONG_T_TIMED]
    log(json.dumps({"long_t_kernels": rows, "device": card}))
    clock["long-T kernels"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as out:
        A.reset_launches()
        lines = timed("measure_audio_flagship", lambda: check_lines(
            measure_audio_flagship.measure(out, epochs=CUT_EPOCHS), name, "audio flagship"))
        launched = bench.launches()
        if min(launched.values()) == 0 or lines[1]["audio_flagship_warm"]["epochs"] != 2:
            raise AssertionError(f"audio flagship: launches {launched}, {lines}")
        log(f"the audio flagship launched {launched}")
        timed("measure_audio_repeats", lambda: check_lines(
            measure_audio_repeats.measure(out, reps=1, epochs=CUT_EPOCHS), name, "audio repeats"))
        lines = timed("measure_vision_flagship", lambda: check_lines(
            measure_vision_flagship.measure(out, epochs=CUT_EPOCHS), name, "vision flagship"))
        if "error" in lines[2]["vision_stacked2"]:
            raise AssertionError(f"the stacked vision pair did not finish: {lines[2]}")
        timed("measure_vision_repeats", lambda: check_lines(
            measure_vision_repeats.measure(out, reps=1, epochs=CUT_EPOCHS), name,
            "vision repeats"))

    lines = timed("probe_frozen_cache", lambda: check_lines(
        probe_frozen_cache.probe(epochs=1), name, "frozen-cache probe"))
    losses = lines[-1]["frozen_losses"]
    if not all(math.isfinite(v) for v in losses["cached"] + losses["backbone"]):
        raise AssertionError(f"frozen-cache probe: losses {losses}")
    timed("ast_ablation", lambda: check_lines(ast_ablation.ablate(steps=3), name, "AST ablation"))
    timed("ast_component_times", lambda: check_lines(
        ast_component_times.measure(steps=3), name, "AST components"))
    A.reset_launches()
    lines = timed("flash_layout_experiment", lambda: check_lines(
        flash_layout_experiment.experiment(steps=3), name, "layout experiment"))
    launched = bench.launches()
    rtol = TOLERANCE["bfloat16"]["out"][1]
    if min(launched.values()) == 0 or not lines[-1]["rel"] <= rtol:
        raise AssertionError(f"layout experiment: launches {launched}, {lines[-1]}")
    log(f"the layout experiment: losses {lines[-1]['loss_match']}, relative "
        f"{lines[-1]['rel']:.3g} (bf16 rtol {rtol}); K1-K3 launched {launched}")
    timed("vit_ablation", lambda: check_lines(vit_ablation.ablate(steps=2), name, "ViT ablation"))
    A.reset_launches()
    timed("microbench all", lambda: check_lines(microbench.run("all", steps=2), name, "microbench"))
    timed("microbench vit", lambda: check_lines(microbench.run("vit", steps=2), name,
                                                "microbench vit"))
    timed("microbench --long", lambda: check_lines(
        microbench.run("flash4k", long=True, steps=2), name, "microbench --long"))
    log(f"microbench's run launched {bench.launches()}")
    timed("family_microbench", lambda: check_lines(
        family_microbench.run(steps=3), name, "family microbench"))
    for stack in (8, 42):
        lines = timed(f"eegnet_stacked_ablation S {stack}", lambda: check_lines(
            eegnet_stacked_ablation.ablate(stack=stack, iters=2), name, "EEGNet ablation"))
        if not all(math.isfinite(v) for line in lines for v in line["first_step_loss"]):
            raise AssertionError(f"EEGNet ablation: {lines}")
    timed("measure_mtcnn", lambda: check_lines(measure_mtcnn.measure(frames=10), name, "MTCNN"))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "metrics.jsonl")
        with open(path, "w") as f:
            f.write(sweep_metrics)
        lines = timed("farm_makespan", lambda: farm_makespan.project(path, workers=2, scale=0.02))
    if lines[-1]["tasks_done"] != lines[0]["tasks"]:
        raise AssertionError(f"farm replay: {lines}")
    log("phase 28 seconds by script: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items())
        + f" on {card}")


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
    causal = check_causal_kernels(card)
    mark("3b. causal kernels")
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
    check_stacked_flash(card)
    for impl in ("math", "flash"):
        time_stacked_step(card, "ast_finetune", 2, "AST-base, unfrozen, bs 8 a subject, bf16, "
                          f"{impl} attention, remat 'attn'", impl)
    for subjects in (2, 4):
        time_kernels_at(card, subjects * B * H, f"a stack of {subjects}'s shape")
    mark("15. stacked AST")
    # fusion's host-bound head fits outside the deterministic mode
    run_fusion_phase(card, eeg_pipelines(eeg_root.name, "stacked"))
    mark("16. fusion")

    with tempfile.TemporaryDirectory() as ckpt_root:
        ast_ckpt = check_checkpoint_import(card, ckpt_root)
        run_audio_from_checkpoint(card, ast_ckpt)
        mark("17. checkpoint import")
        check_scnn_frontend(card)
        run_scnn_path(card)
        scnn_ms = time_train_step(card, "scnn_audio",
                                  "SCNN (scnn_audio), bs 64, 180-d features, float32")
        mark("18. scnn_audio")
        check_resnet_forward(card)
        run_resnet_path(card, check_resnet_import(card, ckpt_root))
        time_train_step(card, "resnet_vision",
                        "ResNet50 + attention (resnet_vision), unfrozen, bs 32, 224 x 224, "
                        "float32, TF32 off")
        profile_train_step(card, "resnet_vision", top=12)
        mark("19. resnet_vision")

    run_mtcnn_phase(card)
    mark("20. MTCNN")
    run_sweep_phase(card, eeg_root.name)
    mark("21. sweep")
    run_cli_phase(card, eeg_root.name, scnn_ms)
    mark("22. CLI")
    run_native_phase(card, eeg_root.name)
    mark("23. native ingest")
    run_multi_card_phases(card, eeg_root.name)
    from eav_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(2, "cuda")
    log(f"dryrun_multichip(2, 'cuda'): {time.perf_counter() - t0:.1f} s (2 gloo ranks on "
        f"cuda:0, the farm's 2 workers on cuda:0) on {card}")
    mark("26. dry run")
    eeg_root.cleanup()
    sweep_metrics = run_measurement_phase(card)
    mark("27. measurement entry points")
    run_scripts_phase(card, sweep_metrics)
    mark("28. chip measurement scripts")

    kernels = []
    for n, (source, replaces) in KERNEL_TABLE.items():
        ms, ms_run, plain, lib, lib_run = times[n]
        kernels.append({
            "name": n, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[n], "max_abs_err": errs[n], "ms": ms, "ms_run": ms_run,
            "plain_ms": plain,
            "bound_ms": bounds[n][0], "bound_by": bounds[n][1], "library_ms": lib,
            "library_ms_run": lib_run, "causal": causal.get(n),
        })
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
