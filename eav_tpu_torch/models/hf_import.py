"""HF checkpoints -> the port's AST and ViT state dicts, as
``eav_tpu/models/hf_import.py`` maps them onto the Flax trees.

The reference loads ``from_pretrained`` checkpoints and swaps the classifier
(`Transformer_Audio.py:22-24`, `Transformer_Vision.py:29-30`). The port's
modules keep their own names (``models/ast.py``, ``models/vit.py``), so the
import is a renaming, and one fusion: HF keeps q, k and v as three Linears,
the port's encoder one ``qkv`` Linear whose rows are q, k, v. The swapped
head is drawn as the JAX package draws it (``np.random.default_rng(head_seed)``,
kernel (fan_in, fan_out) then bias, uniform in +-1/sqrt(fan_in), torch's
Linear init); the port's weight is that kernel transposed, so both packages
start from the same head. AST keeps the checkpoint's ``classifier.layernorm``.

Checkpoints are read from a local directory: ``model.safetensors`` through
this module's own reader (an 8-byte little-endian header length, a JSON
header, then the raw little-endian buffers), else ``pytorch_model.bin``
through ``torch.load(weights_only=True)``. No weights ship with the repo.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# safetensors dtype names <-> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}

# HF encoder layer names -> the port's (models/transformer.py)
_LAYER_RENAMES = (
    ("layernorm_before", "ln1"),
    ("layernorm_after", "ln2"),
    ("attention.output.dense", "attn.out"),
    ("intermediate.dense", "fc1"),
    ("output.dense", "fc2"),
)
_QKV = ("query", "key", "value")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        raw = np.frombuffer(data, np.uint8, count=end - begin, offset=begin).copy()
        out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> None:
    """Writes ``tensors`` in the safetensors format (names sorted, buffers
    packed in that order, the header padded with spaces to 8 bytes)."""
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        blob = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)


def load_state_dict_from_dir(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of a local HF checkpoint directory: ``model.safetensors``
    if present, else ``pytorch_model.bin``; neither raises FileNotFoundError."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.isfile(st_path):
        return read_safetensors(st_path)
    if os.path.isfile(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(
        f"no model.safetensors or pytorch_model.bin under {model_dir!r}; pretrained "
        "weights are not shipped with the repo: put a checkpoint there")


def torch_linear_init(rng: np.random.Generator, fan_in: int, fan_out: int):
    """A fresh torch.nn.Linear, drawn as the JAX package draws it: kernel
    (fan_in, fan_out) then bias, both uniform in +-1/sqrt(fan_in)."""
    bound = 1.0 / np.sqrt(fan_in)
    kernel = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
    bias = rng.uniform(-bound, bound, size=(fan_out,)).astype(np.float32)
    return kernel, bias


def _names(prefix: str, num_layers: int, tokens: Tuple[Tuple[str, str], ...],
           classifier_ln: Optional[str]) -> List[Tuple[str, str]]:
    """(HF name, port name) of every tensor the import renames one to one:
    the embeddings, each layer but its q/k/v, the final and classifier
    LayerNorms. The head and the fused qkv are handled apart."""
    pairs = [(f"{prefix}.embeddings.{hf}", port) for hf, port in tokens]
    emb = f"{prefix}.embeddings.patch_embeddings.projection"
    pairs += [(f"{emb}.weight", "patch_proj.weight"), (f"{emb}.bias", "patch_proj.bias")]
    for i in range(num_layers):
        for hf, port in _LAYER_RENAMES:
            for leaf in ("weight", "bias"):
                pairs.append((f"{prefix}.encoder.layer.{i}.{hf}.{leaf}",
                              f"encoder.layer_{i}.{port}.{leaf}"))
    for leaf in ("weight", "bias"):
        pairs.append((f"{prefix}.layernorm.{leaf}", f"final_ln.{leaf}"))
        if classifier_ln is not None:
            pairs.append((f"{classifier_ln}.{leaf}", f"classifier_ln.{leaf}"))
    return pairs


def _count_layers(sd: Mapping, prefix: str) -> int:
    rx = re.compile(re.escape(prefix) + r"\.encoder\.layer\.(\d+)\.")
    found = {int(m.group(1)) for m in map(rx.match, sd) if m}
    return max(found) + 1 if found else 0


def _convert(sd: Mapping, prefix: str, tokens, classifier_ln: Optional[str], head: str,
             num_labels: int, head_seed: int, num_layers: Optional[int],
             swap_head: bool) -> Dict[str, torch.Tensor]:
    def f32(name):
        return torch.as_tensor(sd[name]).detach().to("cpu", torch.float32).clone()

    n = _count_layers(sd, prefix) if num_layers is None else num_layers
    out = {port: f32(hf) for hf, port in _names(prefix, n, tokens, classifier_ln)}
    for i in range(n):
        attn = f"{prefix}.encoder.layer.{i}.attention.attention"
        for leaf in ("weight", "bias"):
            out[f"encoder.layer_{i}.attn.qkv.{leaf}"] = torch.cat(
                [f32(f"{attn}.{w}.{leaf}") for w in _QKV], dim=0)
    if swap_head:
        hidden = out["final_ln.weight"].shape[0]
        kernel, bias = torch_linear_init(np.random.default_rng(head_seed), hidden, num_labels)
        out["classifier.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        out["classifier.bias"] = torch.from_numpy(bias)
    else:
        out["classifier.weight"], out["classifier.bias"] = f32(f"{head}.weight"), f32(f"{head}.bias")
    return out


def convert_ast_state_dict(sd: Mapping, num_labels: int = 5, head_seed: int = 0,
                           num_layers: Optional[int] = None,
                           swap_head: bool = True) -> Dict[str, torch.Tensor]:
    """HF ``ASTForAudioClassification`` state dict -> ``AST``'s, the classifier
    swapped for ``num_labels`` outputs (``swap_head=False`` keeps the
    checkpoint's); ``num_layers`` None counts the checkpoint's layers."""
    return _convert(sd, "audio_spectrogram_transformer",
                    (("cls_token", "cls_token"), ("distillation_token", "dist_token"),
                     ("position_embeddings", "pos_embed")),
                    "classifier.layernorm", "classifier.dense",
                    num_labels, head_seed, num_layers, swap_head)


def convert_vit_state_dict(sd: Mapping, num_labels: int = 5, head_seed: int = 0,
                           num_layers: Optional[int] = None,
                           swap_head: bool = True) -> Dict[str, torch.Tensor]:
    """HF ``ViTForImageClassification`` state dict -> ``ViT``'s, the classifier
    swapped (`Transformer_Vision.py:30`)."""
    return _convert(sd, "vit", (("cls_token", "cls_token"),
                                ("position_embeddings", "pos_embed")),
                    None, "classifier", num_labels, head_seed, num_layers, swap_head)


def to_hf_state_dict(sd: Mapping[str, torch.Tensor], kind: str) -> Dict[str, torch.Tensor]:
    """The inverse renaming: an ``AST`` (``kind='ast'``) or ``ViT``
    (``'vit'``) state dict -> the HF checkpoint's names, q/k/v split. It
    writes checkpoints of seeded weights where no real one may be fetched."""
    if kind == "ast":
        prefix, head = "audio_spectrogram_transformer", "classifier.dense"
        tokens = (("cls_token", "cls_token"), ("distillation_token", "dist_token"),
                  ("position_embeddings", "pos_embed"))
        cls_ln = "classifier.layernorm"
    elif kind == "vit":
        prefix, head, cls_ln = "vit", "classifier", None
        tokens = (("cls_token", "cls_token"), ("position_embeddings", "pos_embed"))
    else:
        raise ValueError(f"kind {kind!r} not in ('ast', 'vit')")
    n = sum(1 for k in sd if k.endswith(".attn.qkv.weight"))
    out = {hf: sd[port].detach().clone() for hf, port in _names(prefix, n, tokens, cls_ln)}
    for i in range(n):
        attn = f"{prefix}.encoder.layer.{i}.attention.attention"
        for leaf in ("weight", "bias"):
            for w, part in zip(_QKV, sd[f"encoder.layer_{i}.attn.qkv.{leaf}"].chunk(3, dim=0)):
                out[f"{attn}.{w}.{leaf}"] = part.detach().clone()
    out[f"{head}.weight"] = sd["classifier.weight"].detach().clone()
    out[f"{head}.bias"] = sd["classifier.bias"].detach().clone()
    return out
