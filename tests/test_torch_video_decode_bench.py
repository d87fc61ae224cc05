"""The port's ``eav_tpu_torch/scripts/bench_video_decode.py`` on the CPU at a
tiny size, against the JAX package's ``scripts/bench_video_decode.py``
(loaded by path; its ``eav_tpu`` imports sit inside its ``main``): the same
clips, the same reference loop frame for frame, the same variants printed
with JAX's keys plus ``host``, and ``ImportError`` without cv2.
"""

import ast
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest

pytest.importorskip("cv2")

from eav_tpu_torch.scripts import bench_video_decode as BV  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "bench_video_decode.py")
TINY = ["--clips", "2", "--wh", "64x48", "--frames", "60"]


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """The JAX script as a module, with every temporary directory (its
    clips') under ``tmp_path``."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    spec = importlib.util.spec_from_file_location("jax_bench_video_decode", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _variants(mp4_supported):
    return ["reference_serial", "grab_serial", *(["native_serial"] if mp4_supported else []),
            "threaded"]


def _jax_printed_keys():
    """The keys of the dict literals the JAX script prints."""
    with open(JAX_SCRIPT) as f:
        tree = ast.parse(f.read())
    return {frozenset(k.value for k in node.keys) for node in ast.walk(tree)
            if isinstance(node, ast.Dict) and node.keys
            and all(isinstance(k, ast.Constant) for k in node.keys)}


def test_clips_and_reference_loop_equal_jaxs(jax_bench):
    port_paths = BV.make_clips(3, 64, 48, frames=60)
    jax_paths = jax_bench.make_clips(3, 64, 48, frames=60)
    assert [os.path.basename(p) for p in port_paths] == [os.path.basename(p) for p in jax_paths]
    for p, j in zip(port_paths, jax_paths):
        got, want = BV.reference_read_loop(p), BV.reference_read_loop(j)
        assert len(got) == len(want) == 10
        np.testing.assert_array_equal(np.stack(got), np.stack(want))
        jax_frames = jax_bench.reference_read_loop(p)
        assert len(jax_frames) == len(got)
        for g, w in zip(got, jax_frames):
            assert g.shape == (48, 64, 3) and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)
        # a stride and a cap other than the defaults
        np.testing.assert_array_equal(np.stack(BV.reference_read_loop(p, 4, 30)),
                                      np.stack(jax_bench.reference_read_loop(p, 4, 30)))


def test_main_prints_jaxs_variants_with_jaxs_keys(jax_bench, capsys):
    from eav_tpu.ingest import native as jax_native
    from eav_tpu_torch.ingest import native

    lines = BV.main(TINY)
    captured = capsys.readouterr()
    assert [json.loads(line) for line in captured.out.splitlines()] == lines
    assert ("native_serial left out" in captured.err) == (not native.mp4_supported())
    assert jax_bench.main(TINY) == 0
    jax_lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]

    assert [line["variant"] for line in lines] == _variants(native.mp4_supported())
    assert [line["variant"] for line in jax_lines] == _variants(jax_native.mp4_supported())
    want_keys = _jax_printed_keys()
    assert {frozenset(line) for line in jax_lines} <= want_keys
    host = BV.host_line()
    assert host["cores"] == os.cpu_count() and host["cpu"]
    for line in lines:
        assert line.pop("host") == host
        assert frozenset(line) in want_keys
        assert line["clips_per_s"] > 0
    assert lines[0]["speedup"] == 1.0


def test_main_raises_without_cv2(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        BV.main(TINY)
    assert capsys.readouterr().out == ""
    assert os.listdir(tmp_path) == []  # no clip was written
