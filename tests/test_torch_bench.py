"""The port's measurement entry points on the CPU: ``eav_tpu_torch/entry.py``
(``__graft_entry__.entry``), ``scripts/bench.py`` (the root ``bench.py``:
its analytic model equal to the root file's, loaded by path here only, and
its JSON lines on ``ast_tiny``), ``scripts/sweep_sim.py`` at a cut size and
``scripts/run_production_sweep.py`` (its cache names equal to the JAX
pipelines', its command line, its caches read back by the pipelines, its
summary of a handwritten ``metrics.jsonl``)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from eav_tpu_torch.scripts import bench as B
from eav_tpu_torch.scripts import run_production_sweep as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(hidden=32, layers=2, heads=2, mlp_dim=64, max_frames=128)  # ast_tiny's widths
TINY_DIMS = dict(t=146, hidden=32, mlp=64, layers=2, patch=16)  # 12 x 12 patches + 2 tokens
EEGNET_TINY = dict(chans=4, samples=64, kern_length=16, f1=4, d=2, f2=8)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (the runner runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def root_bench(tmp_path, monkeypatch):
    """The JAX package's ``bench.py``, loaded from its path (its import sets
    a default compilation-cache variable, held here to a scratch path)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(REPO, "bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dims", [{}, TINY_DIMS])
def test_analytic_model_equals_the_root_bench(root_bench, dims):
    assert B.ast_train_flops_per_sample(**dims) == root_bench.ast_train_flops_per_sample(**dims)
    assert B.ast_param_count(**dims) == root_bench.ast_param_count(**dims)
    shape = {k: v for k, v in dims.items() if k != "patch"}
    for batch in (1, 8):
        assert (B.ast_step_hbm_bytes(batch, **shape)
                == root_bench.ast_step_hbm_bytes(batch, **shape))


def test_param_count_equals_the_port_models():
    from eav_tpu_torch.models.ast import AST, ast_tiny

    assert B.ast_param_count() == sum(p.numel() for p in AST().parameters())
    tiny = ast_tiny()
    assert B.ast_dims(tiny) == TINY_DIMS
    assert B.ast_param_count(**TINY_DIMS) == sum(p.numel() for p in tiny.parameters())


def test_roofline_uses_the_cards_peaks():
    """The H100's published peaks, the floors by operations and bytes, and
    no TPU variant; an unknown card raises rather than reporting no MFU."""
    peak_flops, peak_bytes = B.card_peaks("NVIDIA H100 80GB HBM3")
    assert (peak_flops, peak_bytes) == (989e12, 3.35e12)
    rl = B.ast_roofline(100.0, peak_flops, peak_bytes)
    t_ops = 8 * B.ast_train_flops_per_sample() / peak_flops
    t_bytes = B.ast_step_hbm_bytes(8)["total"] / peak_bytes
    assert rl["bound_by"] == ("operations" if t_ops > t_bytes else "bytes")
    assert rl["ceiling_sps"] == round(8 / max(t_ops, t_bytes), 1)
    assert rl["roofline_pct"] == round(100 * 100.0 / (8 / max(t_ops, t_bytes)), 1)
    assert not any("eff" in k for k in rl)
    with pytest.raises(ValueError, match="no published peaks"):
        B.card_peaks("NVIDIA A100-SXM4-80GB")


def test_flagship_line_on_ast_tiny():
    """The production step on ast_tiny through the kernels' plain versions:
    the JAX script's keys and the port's, the card-only keys null on the
    CPU, no launch (plain versions count none), no baseline by default."""
    m = B.bench_ast(steps=2, device="cpu", n_train=16, attn_impl="flash", **TINY)
    line = B.flagship_line(m, CPU)
    assert list(line)[:10] == ["metric", "value", "unit", "vs_baseline", "baseline", "tflops",
                               "mfu_pct", "roofline_pct", "ceiling_sps", "device"]
    assert line["metric"] == "ast_finetune_samples_per_sec" and line["value"] > 0
    assert line["vs_baseline"] is None and line["baseline"] is None
    assert line["mfu_pct"] is None and line["roofline_pct"] is None and line["device"] == "cpu"
    assert line["launches_per_step"] == {"flash_fwd": 0, "flash_dkv": 0, "flash_dq": 0}
    assert line["wall_ms_per_step"] > 0 and line["peak_gib"] is None
    assert line["tflops"] == round(line["value"] * B.ast_train_flops_per_sample(**TINY_DIMS)
                                   / 1e12, 1)
    json.dumps(line)


def test_stacked_line_on_ast_tiny():
    m = B.bench_ast_stacked(2, steps=1, device="cpu", **TINY)
    line = B.stacked_line(m, CPU, 2, "flash", "attn")
    assert line["metric"] == "ast_finetune_samples_per_sec_stacked2_flash_remat-attn"
    assert line["value"] > 0 and line["subjects"] == 2 and line["vs_baseline"] is None
    assert B.stacked_line(m, CPU, 4, "math", "none")["metric"] == (
        "ast_finetune_samples_per_sec_stacked4_math")


def test_torch_ast_baseline_at_tiny_widths():
    """The reference-style torch AST step that ``EAV_BENCH_MEASURE_TORCH``
    measures, at ast_tiny's widths (146 tokens)."""
    sps = B.bench_torch_ast_cpu(steps=1, batch=2, **TINY)
    assert np.isfinite(sps) and sps > 0


@pytest.mark.parametrize("live", [False, True], ids=["default", "measure_torch"])
@pytest.mark.parametrize("mode", ["flagship", "stacked"])
def test_main_fills_the_baseline_only_when_measured_live(monkeypatch, capsys, mode, live):
    """``main()`` at ast_tiny's widths: ``vs_baseline`` and ``baseline`` null
    by default, and from the live torch step with ``EAV_BENCH_MEASURE_TORCH``;
    ``--stacked`` takes its stack from ``EAV_BENCH_STACK``."""
    import functools

    for name in ("bench_ast", "bench_ast_stacked", "bench_torch_ast_cpu"):
        monkeypatch.setattr(B, name, functools.partial(getattr(B, name), **TINY))
    monkeypatch.setenv("EAV_BENCH_STACK", "2")
    if live:
        monkeypatch.setenv("EAV_BENCH_MEASURE_TORCH", "1")
    else:
        monkeypatch.delenv("EAV_BENCH_MEASURE_TORCH", raising=False)
    argv = ["--device", "cpu", "--steps", "1"] + (["--stacked"] if mode == "stacked" else [])
    line = B.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == line
    assert line["metric"] == ("ast_finetune_samples_per_sec_stacked2_flash_remat-attn"
                              if mode == "stacked" else "ast_finetune_samples_per_sec")
    if live:
        assert line["baseline"] == "torch-cpu-measured-live" and line["vs_baseline"] > 0
    else:
        assert line["baseline"] is None and line["vs_baseline"] is None


def test_eegnet_bench_at_a_cut_size():
    sps = B.bench_eegnet(2, 1, "cpu", n_tr=20, n_te=10, **EEGNET_TINY)
    assert np.isfinite(sps) and sps > 0


def test_entry_on_ast_tiny():
    """``entry()``'s (forward, (module, x)): an eval-mode module and a zero
    input of the model's shape; the forward keeps no graph."""
    from eav_tpu_torch.entry import entry

    forward, (model, x) = entry("cpu", attn_impl="flash", **TINY)
    assert not model.training and x.shape == (8, 128, 128) and not x.any()
    out = forward(model, x)
    assert out.shape == (8, 5) and torch.isfinite(out).all() and not out.requires_grad


def test_sweep_sim_at_a_cut_size(capsys):
    """Three subjects in groups of 2 (a full and a partial group)."""
    from eav_tpu_torch.scripts import sweep_sim

    line = sweep_sim.run(3, 2, "cpu", epochs=1, n_tr=10, n_te=5, **EEGNET_TINY)
    assert line["metric"] == "eegnet_42subject_sweep_wall_clock"
    assert (line["subjects"], line["epochs"], line["group"], line["device"]) == (3, 1, 2, "cpu")
    assert line["value"] > 0 and line["samples_per_sec"] > 0
    assert capsys.readouterr().out.splitlines() == ["# group done: 2/3", "# group done: 3/3"]


def test_cache_names_equal_the_jax_pipelines():
    from eav_tpu.train.pipeline import _cfg_hash, default_presets

    presets = default_presets()
    for s in (1, 42):
        assert P.cache_names(s) == {
            "eeg": f"s{s:02d}_eeg_{_cfg_hash(presets['eeg'].eeg)}.npz",
            "aud": f"s{s:02d}_aud_fbank_{_cfg_hash(presets['audio'].audio)}.npz",
            "vis": f"s{s:02d}_vis_{_cfg_hash(presets['vision'].vision)}.npz",
        }


def test_caches_link_subjects_and_the_pipelines_read_them(tmp_path):
    """At a cut shape: subjects 2-3 are hard links to subject 1's files, and
    each pipeline's loader hits its file."""
    from eav_tpu_torch.train.pipeline import ModalityPipelines

    shapes = {"eeg": (10, 30, 500), "aud": (10, 16, 8), "vis": (10, 2, 4, 4, 3)}
    P.build_caches(str(tmp_path), [1, 2, 3], shapes)
    for key in shapes:
        inodes = {os.stat(tmp_path / P.cache_names(s)[key]).st_ino for s in (1, 2, 3)}
        assert len(inodes) == 1
    pipes = ModalityPipelines(str(tmp_path / "nonexistent"), cache_dir=str(tmp_path), device="cpu")
    for load, key in ((pipes.load_eeg, "eeg"), (pipes.load_audio, "aud"),
                      (pipes.load_vision, "vis")):
        x, y = load(3)
        assert x.shape == shapes[key] and list(y) == [0, 0, 1, 1, 2, 2, 3, 3, 4, 4]
    assert np.asarray(pipes.load_vision(2)[0]).dtype == np.uint8


def test_the_cli_command_cuts_epochs_by_set_only(tmp_path):
    """JAX's four ``--set`` epoch cuts, the port's flags, no TPU tunnel flag;
    none with ``--full``."""
    import argparse

    args = argparse.Namespace(subjects="1-3", out=str(tmp_path), subject_parallel=42,
                              chip_parallel=0, device="cuda", checkpoint=True,
                              skip_fusion=False, full=False)
    cmd = P.cli_command(args, str(tmp_path / "cache"))
    assert cmd[:4] == [sys.executable, "-m", "eav_tpu_torch.cli", "run"]
    sets = [cmd[i + 1] for i, a in enumerate(cmd) if a == "--set"]
    assert sets == ["audio.finetune.phases.0.epochs=1", "audio.finetune.phases.1.epochs=2",
                    "vision.finetune.phases.0.epochs=2", "vision.finetune.phases.1.epochs=1"]
    for flag, value in (("--modalities", "eeg,audio,vision,fusion"), ("--subject-parallel", "42"),
                        ("--device", "cuda"), ("--subjects", "1-3")):
        assert cmd[cmd.index(flag) + 1] == value
    assert "--checkpoint" in cmd and "--chip-parallel" not in cmd
    assert not {"--epochs-per-call", "--epc-target-seconds"} & set(cmd)
    args.full, args.skip_fusion, args.chip_parallel = True, True, 2
    cmd = P.cli_command(args, str(tmp_path / "cache"))
    assert "--set" not in cmd and cmd[cmd.index("--modalities") + 1] == "eeg,audio,vision"
    assert cmd[cmd.index("--chip-parallel") + 1] == "2"


def test_summary_of_a_handwritten_sweep(tmp_path):
    """Stacked EEG rows divide their group's fit and load by the group size;
    the fit minutes scale to the full protocol's epochs; ``gpu_util_pct`` is
    the mean utilization over each modality's stretch of the journal."""
    rows = [{"subject": s, "modality": "eeg", "fit_seconds": 120.0, "load_seconds": 6.0,
             "archive_seconds": 0.5, "epochs": 200, "group_size": 2} for s in (1, 2)]
    rows += [{"subject": s, "modality": "audio", "fit_seconds": 6.0, "load_seconds": 1.2,
              "archive_seconds": 0.3, "epochs": 3} for s in (1, 2)]
    rows += [{"subject": s, "modality": "fusion", "accuracy": 0.2, "wall_clock_s": 3.0}
             for s in (1, 2)]
    rows += [{"event": "farm_summary", "makespan_s": 1.0}, {"aggregate": True}]
    metrics = tmp_path / "metrics.jsonl"
    metrics.write_text("".join(json.dumps(r) + "\n" for r in rows))
    t0 = 1000.0
    journal = tmp_path / "journal.jsonl"
    recs = [{"task": "subject01_eeg", "status": "done", "ts": t0 + 120},
            {"task": "subject02_eeg", "status": "done", "ts": t0 + 121},
            {"task": "subject01_audio", "status": "failed", "ts": t0 + 140},
            {"task": "subject02_audio", "status": "done", "ts": t0 + 130},
            {"task": "subject01_audio", "status": "done", "ts": t0 + 141}]
    journal.write_text("".join(json.dumps(r) + "\n" for r in recs))
    samples = [(t0 + i + 0.5, 50.0 if i < 121 else 10.0) for i in range(141)]
    report = P.summarize(str(metrics), str(journal), samples, t0)
    eeg, audio = report["eeg"], report["audio"]
    assert eeg == {"measured_minutes": 2.0, "epochs_ran": 200, "full_protocol_minutes_est": 2.0,
                   "subjects": 2, "group_sizes": [2], "load_minutes": 0.1,
                   "archive_minutes": round(1.0 / 60, 2), "gpu_util_pct": 50.0}
    assert audio["measured_minutes"] == 0.2 and audio["full_protocol_minutes_est"] == round(
        12.0 * 25 / 3 / 60, 2)
    assert audio["group_sizes"] == [1] and audio["gpu_util_pct"] == 10.0
    assert report["fusion"]["measured_minutes"] == report["fusion"][
        "full_protocol_minutes_est"] == 0.1 and report["fusion"]["epochs_ran"] == 100
    assert report["total"]["measured_minutes"] == 2.3
    assert report["total"]["gpu_util_pct"] == round(np.mean([u for _, u in samples]), 1)
    assert "gpu_util_pct" not in P.summarize(str(metrics))["eeg"]
