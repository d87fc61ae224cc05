"""The port's multi-card entry points on the CPU: ``cli run --data-parallel
2 --device cpu`` over a tiny vision subject (two spawned gloo ranks,
decoding its clips with the native libav reader) against ``--data-parallel
1``, and ``parallel/dryrun.dryrun_multichip(2, "cpu")``, the port of
``__graft_entry__.dryrun_multichip``'s legs. Logits to rtol = atol = 2e-4,
the JAX package's data-parallel bound (``tests/test_parallel.py:77``)."""

import json

import numpy as np
import pytest
import torch

from eav_tpu_torch import cli
from eav_tpu_torch.parallel.dryrun import dryrun_multichip

EMOTIONS = ("Neutral", "Sadness", "Anger", "Happiness", "Calmness")
# 10 clips of 30 frames -> 5 kept frames a trial; 5 train and 5 test trials;
# 25 train frames at batch 4: the last batch, one frame, splits 1 / 0
VISION_SET = [
    "vision.vision.max_frames=30", "vision.vision.frames_per_sample=5", "vision.split.h_idx=1",
    "vision.finetune.model_kwargs.hidden=16", "vision.finetune.model_kwargs.layers=1",
    "vision.finetune.model_kwargs.heads=2", "vision.finetune.model_kwargs.mlp_dim=32",
    "vision.finetune.model_kwargs.patch_size=8", "vision.finetune.model_kwargs.image_size=16",
    "vision.finetune.phases.0.epochs=1", "vision.finetune.phases.1.epochs=2",
    "vision.finetune.phases.1.lr=1e-3", "vision.finetune.batch_size=4",
    "vision.finetune.eval_batch_size=8",
    # float32: bf16 rounds the split batch's products differently (~5e-3 here)
    "vision.finetune.model_kwargs.compute_dtype=float32",
    "vision.finetune.model_kwargs.stream_dtype=float32",
]
TIMING = {"wall_clock_s", "ts", "fit_seconds", "samples_per_sec", "load_seconds",
          "archive_seconds"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks'
    yield
    torch.set_num_threads(n)


def _vision_subject(root):
    import cv2

    vdir = root / "subject01" / "Video"
    vdir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(10):
        emo = EMOTIONS[i % 5]
        vw = cv2.VideoWriter(str(vdir / f"subject_01_Speaking_{i}_{emo}_.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
        base = rng.integers(0, 256, size=(48, 64, 3))
        for f in range(30):
            vw.write(((base + 7 * f + 40 * (i % 5)) % 256).astype(np.uint8))
        vw.release()
    return root


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k not in TIMING} for line in f]


def test_cli_data_parallel_equals_one_rank(tmp_path, monkeypatch):
    monkeypatch.delenv("EAV_TPU_MTCNN_WEIGHTS", raising=False)  # the center crop
    root = _vision_subject(tmp_path / "EAV")
    sets = [a for kv in VISION_SET for a in ("--set", kv)]
    outs = {}
    for n in (2, 1):
        out = tmp_path / f"dp{n}"
        assert cli.main(["run", "--data-root", str(root), "--subjects", "1", "--modalities",
                         "vision", "--out", str(out), "--device", "cpu", "--data-parallel",
                         str(n), *sets]) == 0
        outs[n] = out
    journal = _records(outs[2] / "journal.jsonl")
    assert journal == _records(outs[1] / "journal.jsonl")
    assert len(journal) == 1 and journal[0]["status"] == "done"  # written once, by rank 0
    rows = _records(outs[2] / "metrics.jsonl")
    assert rows == _records(outs[1] / "metrics.jsonl") and len(rows) == 1
    for split in ("train", "test"):
        got = np.load(outs[2] / "logits" / f"s01_vision_{split}.npy")
        want = np.load(outs[1] / "logits" / f"s01_vision_{split}.npy")
        assert got.shape == (5, 5)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(SystemExit, match="mutually exclusive"):
        cli.main(["run", "--data-root", str(root), "--out", str(tmp_path / "x"), "--device",
                  "cpu", "--data-parallel", "2", "--chip-parallel", "2"])


def test_dryrun_multichip_two_cpu_ranks():
    out = dryrun_multichip(2, "cpu")
    assert out["stacked"] == out["stacked_full"] == out["stacked_partial"] == (2, 8, 5)
    assert out["tp_dp"][:2] == (2, 1) and np.isfinite(out["tp_dp"][2]).all()
    assert out["vit_logits"].shape == (2, 5)
    assert out["farm"]["workers"] == 2
