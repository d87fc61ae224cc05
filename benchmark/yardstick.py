"""The benchmark's fixed arithmetic: the card's published peaks, the
transformer's analytic FLOPs a sample, and the flash kernels' least work.

A copy, so that a change to the program cannot move the yardstick:

- ``encoder_forward_flops`` is ``eav_tpu_torch/scripts/bench.py``'s
  ``ast_train_flops_per_sample`` for any patch-embedded encoder (AST and
  ViT), forward only (``train_flops`` is 3x it, as that function counts);
- ``attention_work`` is ``chip_smoke.py``'s ``kernel_bounds``: each kernel's
  FLOP and bytes at (B·H, T, D), operands read once and outputs written once;
- ``PEAKS`` holds NVIDIA's data sheet for the H100 SXM, dense rates.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Published dense peaks by a substring of the card's name (NVIDIA's data
# sheet, SXM part, at the 700 W power limit): FLOP/s in bf16 on the tensor
# cores, bytes/s of device memory.
PEAKS = {"H100": {"bfloat16": 989e12, "bytes": 3.35e12}}


def card_peaks(name: str) -> Dict[str, float]:
    """The peaks of the card called ``name``; raises for a card the table
    does not hold (a share of an unknown peak is no number)."""
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for the card {name!r}")


def encoder_forward_flops(tokens: int, patches: int, patch_fan_in: int, hidden: int,
                          mlp: int, layers: int) -> float:
    """Matmul FLOPs of one sample's forward through a patch-embedded
    pre-LN encoder: the patch conv (``patch_fan_in`` = channels x patch
    area) over ``patches`` and the layers over ``tokens``: fused qkv,
    scores, context, attention out, MLP. Elementwise work (LayerNorm,
    GELU, softmax) is left out."""
    t = tokens
    per_layer = (2 * t * hidden * 3 * hidden + 4 * t * t * hidden + 2 * t * hidden * hidden
                 + 4 * t * hidden * mlp)
    return float(layers * per_layer + 2 * patches * hidden * patch_fan_in)


def model_dims(model: dict) -> dict:
    """Tokens, patches and the patch conv's fan-in of a configuration's
    ``model`` block (family ``ast`` or ``vit``), with its widths."""
    p = model["patch_size"]
    if model["family"] == "ast":
        rows = (model["num_mel_bins"] - p) // model["frequency_stride"] + 1
        cols = (model["max_frames"] - p) // model["time_stride"] + 1
        patches, extra, fan_in = rows * cols, 2, p * p
    elif model["family"] == "vit":
        patches, extra, fan_in = (model["image_size"] // p) ** 2, 1, 3 * p * p
    else:
        raise ValueError(f"no yardstick for the family {model['family']!r}")
    return {"tokens": patches + extra, "patches": patches, "patch_fan_in": fan_in,
            "hidden": model["hidden"], "mlp": model["mlp_dim"], "layers": model["layers"],
            "heads": model["heads"], "head_dim": model["hidden"] // model["heads"]}


def forward_flops(model: dict) -> float:
    """One sample's forward FLOPs for a configuration's ``model`` block."""
    d = model_dims(model)
    return encoder_forward_flops(d["tokens"], d["patches"], d["patch_fan_in"], d["hidden"],
                                 d["mlp"], d["layers"])


def train_flops(model: dict) -> float:
    """One training sample's FLOPs: 3x the forward."""
    return 3.0 * forward_flops(model)


def attention_work(kernel: str, bh: int, t: int, d: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one bf16 flash kernel call at (``bh``, ``t``, ``d``):
    ``fwd`` (K1) 4·BH·T²·D, ``dkv`` (K2) 8·, ``dq`` (K3) 6·; each (BH, T,
    D) operand and each float32 (BH, T) row statistic read once, each
    output written once."""
    mat = bh * t * d * 2
    row = bh * t * 4
    work = {
        "fwd": (4 * t * t * d * bh, 3 * mat + mat + row),
        "dkv": (8 * t * t * d * bh, 4 * mat + 2 * row + 2 * mat),
        "dq": (6 * t * t * d * bh, 4 * mat + 2 * row + mat),
    }
    return work[kernel]


def least_seconds(flop: float, nbytes: float, peaks: Dict[str, float]) -> float:
    """The least time of ``flop`` bf16 operations and ``nbytes`` on a card
    with ``peaks``: the larger of the two bounds."""
    return max(flop / peaks["bfloat16"], nbytes / peaks["bytes"])
