"""The yardstick equals the program's analytic model where it was copied
from: ``eav_tpu_torch/scripts/bench.py`` (FLOPs a sample) and
``chip_smoke.py``'s ``kernel_bounds`` (each kernel's least work)."""

import json

import pytest

from conftest import ROOT

from benchmark import yardstick

AST = json.loads((ROOT / "benchmark/configs/ast_base.json").read_text())["model"]
VIT = json.loads((ROOT / "benchmark/configs/vit_base.json").read_text())["model"]


@pytest.mark.parametrize("block,dims", [
    ({}, {}),
    ({"max_frames": 126, "hidden": 32, "mlp_dim": 64, "layers": 2},
     {"t": 146, "hidden": 32, "mlp": 64, "layers": 2}),
    ({"layers": 1}, {"t": 1214, "layers": 1}),
])
def test_ast_flops_equal_the_program_scripts(block, dims):
    from eav_tpu_torch.scripts import bench

    assert yardstick.train_flops({**AST, **block}) == bench.ast_train_flops_per_sample(**dims)


def test_configuration_flops():
    assert yardstick.train_flops(AST) == pytest.approx(783e9, rel=0.01)
    assert yardstick.model_dims(VIT)["tokens"] == 197
    assert yardstick.model_dims(AST)["tokens"] == 1214
    # ViT-B/16 at 224: 17.6 G multiply-adds a forward (the paper's table 6 family)
    assert yardstick.forward_flops(VIT) == pytest.approx(35.1e9, rel=0.01)


@pytest.mark.parametrize("bh,t", [(96, 1214), (768, 1214), (1536, 197)])
def test_attention_work_equals_kernel_bounds(bh, t):
    import chip_smoke

    peaks = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
    bounds = chip_smoke.kernel_bounds(t, bh)
    for kind, name in (("fwd", "flash_fwd"), ("dkv", "flash_dkv"), ("dq", "flash_dq")):
        least = yardstick.least_seconds(*yardstick.attention_work(kind, bh, t, 64), peaks)
        assert least * 1e3 == pytest.approx(bounds[name][0], rel=1e-12)


def test_unknown_card_has_no_peak():
    with pytest.raises(ValueError):
        yardstick.card_peaks("cpu")
