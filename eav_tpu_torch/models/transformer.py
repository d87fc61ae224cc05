"""Pre-LN ViT-style transformer encoder (AST's backbone), as in
``eav_tpu/models/transformer.py``.

Numerics follow the Flax modules: a Dense with a compute ``dtype`` casts its
input, weight and bias to that dtype while the parameters stay float32 (done
with explicit casts, not autocast, which rounds elsewhere); LayerNorm computes
its statistics and affine in float32 and returns the compute dtype; GELU is
exact (erf); each sublayer's output is cast back to the residual stream's
dtype before the add. Parameter names match the Flax tree
(``ln1``, ``attn.qkv``, ``attn.out``, ``ln2``, ``fc1``, ``fc2``).

Remat recomputes a sublayer in the backward through :class:`Remat`, from
the sublayer's parameters, buffers and dropout masks given as explicit
inputs, serial or stacked alike. ``torch.utils.checkpoint`` cannot serve a
stacked fit (``torch.func.vmap``, ``parallel/subject.py``): it recomputes
after the vmapped call has returned, on tensors of a vmap level that no
longer exists, and with the module's own parameters, not the ones
``functional_call`` swapped in. A stacked fit hands each Dropout its mask;
a serial one draws the sublayer's mask once, before the forward, so that
the recompute applies the same mask.

A layer made tensor-parallel by ``parallel/tp.py`` holds its shard of the
heads and of the MLP's hidden units and the ``tp_group`` of its model axis;
its sublayers then issue Megatron's two collectives (``_EnterTP`` at the
entry of the column-parallel qkv and fc1, ``_ReduceTP`` after the
row-parallel out and fc2, whose bias is added once, after the sum). They
run inside the rematted sublayer, so a recompute runs them again, on every
rank in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call, vjp

from eav_tpu_torch.models.dropout import Dropout
from eav_tpu_torch.ops.attention import LAYOUT, flash_attention
from eav_tpu_torch.utils.profiling import span

ATTN_IMPLS = ("math", "flash", "auto")
REMAT_MODES = ("none", "attn", "full")


def lecun_normal(shape, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Flax's default kernel init: truncated normal (2 std) with variance
    1/fan_in, on the CPU."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``Dense(dtype=dtype)``: input, weight and bias in ``dtype`` (or
    their promoted type when None); parameters stay float32."""
    dtype = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class _EnterTP(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model axis
    (each rank's heads or hidden units give a part of it)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        total = grad.float()  # summed in float32, whatever the activations' dtype
        dist.all_reduce(total, group=ctx.group)
        return total.to(grad.dtype), None


class _ReduceTP(torch.autograd.Function):
    """Sums the ranks' partial outputs over the model axis; the backward is
    the identity (the output, and so its gradient, is replicated).
    ``torch.distributed.nn.functional.all_reduce`` would all-reduce that
    replicated gradient again, multiplying it by the axis's size."""

    @staticmethod
    def forward(x, group):
        total = x.clone()
        dist.all_reduce(total, group=group)
        return total

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def row_parallel(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype],
                 group) -> torch.Tensor:
    """``dense`` of a layer whose input columns are split over ``group``:
    each rank's partial product, summed over the ranks in float32, then the
    bias, once."""
    dtype = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    partial = F.linear(x.to(dtype), layer.weight.to(dtype)).float()
    return (_ReduceTP.apply(partial, group) + layer.bias.float()).to(dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)``: float32 statistics and affine, the
    result in ``dtype`` (float32 when None)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dtype or torch.float32)


class PatchProj(nn.Conv2d):
    """Patch embedding: a VALID strided conv in float32 (the JAX module sets
    no dtype). Weight OIHW (hidden, C, P, P) is the Flax HWIO kernel
    transposed. NCHW in, (B, hidden, rows, cols) out."""

    def __init__(self, in_channels: int, hidden: int, patch_size: int, strides):
        super().__init__(in_channels, hidden, patch_size, stride=tuple(strides))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.float(), self.weight, self.bias, stride=self.stride)


def resolve_attn_impl(impl: str, x: torch.Tensor) -> str:
    """'auto' is the flash kernels for CUDA tensors and math elsewhere."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {impl!r} not in {ATTN_IMPLS}")
    if impl == "auto":
        return "flash" if x.is_cuda else "math"
    return impl


class MultiHeadSelfAttention(nn.Module):
    """Fused q/k/v projection (one (hidden -> 3*hidden) product; weight rows
    ordered q, k, v as the Flax (in, 3, hidden) kernel), attention in the
    (B, T, H, D) layout, output projection."""

    def __init__(self, hidden: int, heads: int, attn_impl: str = "math",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.heads, self.attn_impl, self.dtype = heads, attn_impl, dtype
        self.head_dim = hidden // heads
        self.qkv = nn.Linear(hidden, 3 * hidden)
        self.out = nn.Linear(hidden, hidden)
        self.tp_group = None  # parallel/tp.py: this rank holds ``heads`` of the layer's

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, _ = x.shape
        d = self.head_dim
        if self.tp_group is not None:
            x = _EnterTP.apply(x, self.tp_group)
        q, k, v = dense(x, self.qkv, self.dtype).view(b, t, 3, self.heads, d).unbind(2)
        if resolve_attn_impl(self.attn_impl, x) == "flash":
            ctx = flash_attention(q, k, v)
        else:
            # sqrt(d) rounded to the activation dtype, as the JAX module divides
            root = float(torch.tensor(math.sqrt(d), dtype=x.dtype))
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / root
            probs = torch.softmax(scores, dim=-1)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        with span(LAYOUT, device=True):  # O back to (B, T, H·D), a copy unless contiguous
            ctx = ctx.reshape(b, t, self.heads * d)
        if self.tp_group is not None:
            return row_parallel(ctx, self.out, self.dtype, self.tp_group)
        return dense(ctx, self.out, self.dtype)


class Remat(torch.autograd.Function):
    """``module(x, block=block)`` with nothing kept for the backward but
    its inputs: ``x`` and ``tensors``, the module's own tensors named
    ``names`` (the recompute swaps them in with ``functional_call``). Its
    vmap rule is generated, so it runs inside ``torch.func.vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(module, block, names, x, *tensors):
        with torch.no_grad():
            return functional_call(module, dict(zip(names, tensors)), (x,), {"block": block})

    @staticmethod
    def setup_context(ctx, inputs, output):
        module, block, names, x, *tensors = inputs
        ctx.module, ctx.block, ctx.names = module, block, names
        ctx.save_for_backward(x, *tensors)

    @staticmethod
    def backward(ctx, grad):
        x, *tensors = ctx.saved_tensors
        diff = [i for i, t in enumerate(tensors) if t.is_floating_point()]  # not the masks

        def block(x, *floats):
            given = list(tensors)
            for i, t in zip(diff, floats):
                given[i] = t
            return functional_call(ctx.module, dict(zip(ctx.names, given)), (x,),
                                   {"block": ctx.block})

        _, pull = vjp(block, x, *(tensors[i] for i in diff))
        grads = pull(grad)
        out = [None] * len(tensors)
        for i, g in zip(diff, grads[1:]):
            out[i] = g
        return (None, None, None, grads[0], *out)


class TransformerLayer(nn.Module):
    """Pre-LN block. ``remat``: 'none' keeps every activation for the
    backward; 'attn' recomputes the attention sublayer in the backward;
    'full' recomputes both sublayers."""

    _BLOCK_MODULES = {"attn": ("ln1", "attn", "drop_attn"), "mlp": ("ln2", "fc1", "fc2", "drop_mlp")}

    def __init__(self, hidden: int, heads: int, mlp_dim: int, eps: float = 1e-12,
                 dropout: float = 0.0, attn_impl: str = "math",
                 dtype: Optional[torch.dtype] = None, remat: str = "none"):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat {remat!r} not in {REMAT_MODES}")
        self.dtype, self.remat = dtype, remat
        self.ln1 = nn.LayerNorm(hidden, eps=eps)
        self.attn = MultiHeadSelfAttention(hidden, heads, attn_impl, dtype)
        self.ln2 = nn.LayerNorm(hidden, eps=eps)
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        # one dropout a sublayer, both drawing from the trainer's one generator
        self.drop_attn = Dropout(dropout)
        self.drop_mlp = Dropout(dropout)

    def _attn_block(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop_attn(self.attn(layer_norm(x, self.ln1, self.dtype)))

    def _mlp_block(self, x: torch.Tensor) -> torch.Tensor:
        z = layer_norm(x, self.ln2, self.dtype)
        group = self.attn.tp_group  # parallel/tp.py: the MLP's hidden units are split too
        if group is not None:
            z = _EnterTP.apply(z, group)
        z = F.gelu(dense(z, self.fc1, self.dtype), approximate="none")
        if group is not None:
            return self.drop_mlp(row_parallel(z, self.fc2, self.dtype, group))
        return self.drop_mlp(dense(z, self.fc2, self.dtype))

    def _remat(self, block: str, x: torch.Tensor) -> torch.Tensor:
        tensors = {}
        for name in self._BLOCK_MODULES[block]:
            sub = getattr(self, name)
            tensors.update((f"{name}.{k}", v) for k, v in sub.named_parameters())
            tensors.update((f"{name}.{k}", v) for k, v in sub.named_buffers())  # a stack's masks
            if isinstance(sub, Dropout) and sub.needs_mask():
                # the sublayer's output has x's shape; its one mask serves the recompute too
                tensors[f"{name}.mask"] = sub.draw(x.shape, x.device)
        return Remat.apply(self, block, tuple(tensors), x, *tensors.values())

    def forward(self, x: torch.Tensor, block: Optional[str] = None) -> torch.Tensor:
        """The layer; with ``block`` 'attn' or 'mlp', that sublayer's output
        alone (what remat recomputes)."""
        if block is not None:
            return self._attn_block(x) if block == "attn" else self._mlp_block(x)
        remat = self.remat if torch.is_grad_enabled() else "none"
        attn = self._remat("attn", x) if remat in ("attn", "full") else self._attn_block(x)
        x = x + attn.to(x.dtype)
        mlp = self._remat("mlp", x) if remat == "full" else self._mlp_block(x)
        return x + mlp.to(x.dtype)


class TransformerEncoder(nn.Module):
    """``layers`` TransformerLayers named ``layer_{i}``."""

    def __init__(self, hidden: int, layers: int, heads: int, mlp_dim: int,
                 eps: float = 1e-12, dropout: float = 0.0, attn_impl: str = "math",
                 dtype: Optional[torch.dtype] = None, remat: str = "none"):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(
                f"layer_{i}",
                TransformerLayer(hidden, heads, mlp_dim, eps, dropout, attn_impl, dtype, remat),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x)
        return x
