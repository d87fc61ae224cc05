"""LFM2-MoE (Liquid AI's ``lfm2_moe``: LFM2-8B-A1B, LFM2-24B-A2B), a causal
decoder of gated short convolutions and grouped-query attention with
mixture-of-experts feed-forwards, fine-tuned as EAV's classifier.

The layer equations (the plain reference ``reference/lfm2_moe.py`` follows
them too):

- token ids -> ``embed_tokens``; then each layer i of ``layer_types``:
  h = x + op(RMSNorm(x)), out = h + ffn(RMSNorm(h)), with RMSNorm(x) =
  x / sqrt(mean(x^2) + eps) * g; after the last layer ``embedding_norm``;
- op 'conv', the gated short convolution: [B, C, x~] = split3(W_in u)
  (no bias), y = C * causal_depthwise_conv_L(B * x~), op = W_out y; the
  convolution over positions t-L+1..t, no bias;
- op 'full_attention', causal GQA: q = RMSNorm_D(W_q u), k = RMSNorm_D(W_k
  u) per head, v = W_v u; RoPE (rotate-half, base ``rope_theta``) on q
  and k; softmax(q k^T / sqrt(D)) v over keys j <= i, each K/V head shared
  by H_q / H_kv query heads; then W_o. Through the flash kernels K1-K3
  (``ops/attention.py``) in their causal mode on the card, their plain
  versions on the CPU;
- ffn: the first ``num_dense_layers`` layers a SwiGLU W2(silu(W1 u) * W3 u)
  of width ``intermediate_size``; the others the expert layer of
  ``ops/moe.py`` (``num_experts`` routed by a sigmoid router with the
  expert bias, ``num_experts_per_tok`` a token, width
  ``moe_intermediate_size``), holding ``experts_held`` of them;
- the classifier (EAV's 5-way head): a Linear on the final norm's output
  at the last position, the sequence-classification convention for causal
  backbones.

``layers`` keeps the first layers of ``layer_types`` (a pipeline stage's
share); ``experts_held`` the experts this chip holds of each MoE layer
(expert parallelism's share, ``ops/moe.py``). Every buffer (RoPE's inverse
frequencies, the expert bias, the held experts' places) is out of the state
dict, so the parameters are the state dict.

Numerics as in ``models/transformer.py``: ``compute_dtype`` is the matmuls'
(inputs and weights cast explicitly, parameters float32), ``stream_dtype``
the residual stream's; RMSNorm, RoPE, the router, the final norm and the
head compute in float32.

Spans: ``lfm2.forward`` around the model's whole forward and
``conv.short`` around a short convolution, device-timed when not capturing
(``utils/profiling.span``); the MoE's and attention's are their ops'.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eav_tpu_torch.core.optim import HEAD_REGEX
from eav_tpu_torch.ops.attention import LAYOUT, flash_attention
from eav_tpu_torch.ops.moe import MoE, swiglu
from eav_tpu_torch.utils.profiling import span

MODES = ("full", "features", "head")
FORWARD, CONV = "lfm2.forward", "conv.short"
LAYER_TYPES = ("conv", "full_attention")


def linear(x: torch.Tensor, layer: nn.Linear, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A bias-free Linear with input and weight in ``dtype`` (x's when None)."""
    dtype = dtype or x.dtype
    return F.linear(x.to(dtype), layer.weight.to(dtype))


class _RMSNorm(torch.autograd.Function):
    """x / sqrt(mean(x^2) + eps) * weight in float32, the result in
    ``dtype``; keeps only x (as given) and the rows' 1 / rms for the
    backward (autograd's own keeps two float32 copies of the rows)."""

    @staticmethod
    def forward(ctx, x, weight, eps, dtype):
        xf = x.float()
        rstd = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        ctx.save_for_backward(x, weight, rstd)
        return (xf * rstd * weight).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        x, weight, rstd = ctx.saved_tensors
        n, grad = x.float() * rstd, grad.float()
        dn = grad * weight
        dx = rstd * (dn - n * (dn * n).mean(-1, keepdim=True))
        dw = (grad * n).reshape(-1, n.shape[-1]).sum(0)
        return dx.to(x.dtype), dw, None, None


class RMSNorm(nn.Module):
    """x / sqrt(mean(x^2) + eps) * weight over the last axis, in float32;
    the result in ``dtype`` (float32 when None)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return _RMSNorm.apply(x, self.weight, self.eps, dtype or torch.float32)


def rope(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of (B, T, H, D) float32 ``x`` at positions 0..T-1,
    rotate-half form: x cos + rotate_half(x) sin, cos and sin of t·inv_freq
    repeated over both halves."""
    t = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)[None, :, None, :]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * emb.cos() + rotated * emb.sin()


class ShortConv(nn.Module):
    """The gated short convolution: ``in_proj`` (hidden -> 3 hidden, rows B,
    C, x~), the depthwise causal ``conv`` (weight (hidden, 1, L)) and
    ``out_proj``. The in-projection is three products, one a third of its
    rows, so that B, C and x~ are contiguous (elementwise kernels over
    chunks of one (tokens, 3 hidden) output run strided, without vectorized
    loads); the convolution is L shifted products summed, in the (B, T,
    hidden) layout, each tap's weights a contiguous row."""

    def __init__(self, hidden: int, l_cache: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.in_proj = nn.Linear(hidden, 3 * hidden, bias=False)
        self.conv = nn.Conv1d(hidden, hidden, l_cache, groups=hidden, bias=False)
        self.out_proj = nn.Linear(hidden, hidden, bias=False)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        with span(CONV, device=True):
            dtype, t = self.dtype or u.dtype, u.shape[1]
            u = u.to(dtype)
            b, c, x = (F.linear(u, w) for w in self.in_proj.weight.to(dtype).chunk(3))
            bx = b * x
            taps = self.conv.weight.shape[-1]
            # (L, hidden): tap j reads position t-L+1+j
            w = self.conv.weight[:, 0].t().to(bx.dtype).contiguous()
            padded = F.pad(bx, (0, 0, taps - 1, 0))
            y = padded[:, taps - 1:] * w[-1]
            for j in range(taps - 1):
                y = y + padded[:, j: j + t] * w[j]
            return linear(c * y, self.out_proj, self.dtype)


class Attention(nn.Module):
    """Causal GQA with per-head RMSNorm on q and k and RoPE."""

    def __init__(self, hidden: int, heads: int, kv_heads: int, eps: float, rope_theta: float,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        if hidden % heads or heads % kv_heads:
            raise ValueError(f"hidden {hidden}, {heads} heads over {kv_heads} KV heads")
        self.heads, self.kv_heads, self.dtype = heads, kv_heads, dtype
        self.head_dim = hidden // heads
        d = self.head_dim
        self.q_proj = nn.Linear(hidden, heads * d, bias=False)
        self.k_proj = nn.Linear(hidden, kv_heads * d, bias=False)
        self.v_proj = nn.Linear(hidden, kv_heads * d, bias=False)
        self.out_proj = nn.Linear(heads * d, hidden, bias=False)
        self.q_layernorm = RMSNorm(d, eps)
        self.k_layernorm = RMSNorm(d, eps)
        self.rope_theta = rope_theta
        self.register_buffer("inv_freq", torch.empty(d // 2), persistent=False)
        self.reset_buffers()

    @torch.no_grad()
    def reset_buffers(self) -> None:
        """RoPE's inverse frequencies theta^(-2i/D)."""
        d = self.head_dim
        self.inv_freq.copy_(1.0 / self.rope_theta ** (torch.arange(0, d, 2).float() / d))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        b, t, _ = u.shape
        d, dtype = self.head_dim, self.dtype or u.dtype
        q = linear(u, self.q_proj, dtype).view(b, t, self.heads, d)
        k = linear(u, self.k_proj, dtype).view(b, t, self.kv_heads, d)
        v = linear(u, self.v_proj, dtype).view(b, t, self.kv_heads, d)
        q = rope(self.q_layernorm(q), self.inv_freq).to(dtype)
        k = rope(self.k_layernorm(k), self.inv_freq).to(dtype)
        ctx = flash_attention(q, k, v, causal=True)
        with span(LAYOUT, device=True):  # O back to (B, T, H·D)
            ctx = ctx.reshape(b, t, self.heads * d)
        return linear(ctx, self.out_proj, dtype)


class DenseFFN(nn.Module):
    """SwiGLU: w2(silu(w1 u) * w3 u), no biases. While a gradient is taken
    it is recomputed in the backward (``torch.utils.checkpoint``): at
    11,776 wide it would keep three (tokens, 11,776) tensors, 2.3 GB a layer
    at 32,768 tokens, for about 13% more of the step's FLOPs."""

    def __init__(self, hidden: int, ffn: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.dtype = dtype
        self.w1 = nn.Linear(hidden, ffn, bias=False)
        self.w3 = nn.Linear(hidden, ffn, bias=False)
        self.w2 = nn.Linear(ffn, hidden, bias=False)

    def _ffn(self, u: torch.Tensor) -> torch.Tensor:
        return linear(swiglu(linear(u, self.w1, self.dtype), linear(u, self.w3, self.dtype)),
                      self.w2, self.dtype)

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled():
            return checkpoint(self._ffn, u, use_reentrant=False, preserve_rng_state=False)
        return self._ffn(u)


class DecoderLayer(nn.Module):
    """h = x + op(operator_norm(x)); out = h + feed_forward(ffn_norm(h)); the
    op is ``conv`` or ``self_attn``."""

    def __init__(self, kind: str, moe: bool, hidden: int, cfg: dict):
        super().__init__()
        dtype = cfg["dtype"]
        self.kind, self.dtype = kind, dtype
        self.operator_norm = RMSNorm(hidden, cfg["eps"])
        self.ffn_norm = RMSNorm(hidden, cfg["eps"])
        if kind == "conv":
            self.conv = ShortConv(hidden, cfg["l_cache"], dtype)
        else:
            self.self_attn = Attention(hidden, cfg["heads"], cfg["kv_heads"], cfg["eps"],
                                       cfg["rope_theta"], dtype)
        if moe:
            self.feed_forward = MoE(hidden, cfg["moe_ffn"], cfg["experts"], cfg["top_k"],
                                    cfg["experts_held"], cfg["norm_topk"], cfg["scaling"], dtype)
        else:
            self.feed_forward = DenseFFN(hidden, cfg["ffn"], dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        op = self.conv if self.kind == "conv" else self.self_attn
        x = x + op(self.operator_norm(x, self.dtype)).to(x.dtype)
        # the router reads the norm's float32 output; the experts cast it
        u = self.ffn_norm(x, None if isinstance(self.feed_forward, MoE) else self.dtype)
        return x + self.feed_forward(u).to(x.dtype)


class Decoder(nn.Module):
    """The layers, ``layers.{i}``; the last layer's output is the module's
    (before ``embedding_norm``)."""

    def __init__(self, blocks: Sequence[DecoderLayer]):
        super().__init__()
        self.layers = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class Lfm2Moe(nn.Module):
    """The classifier: (B, T) int64 token ids -> (B, num_labels) logits.
    The constructor takes the published config's keys (``config.json`` of
    an ``lfm2_moe`` model), ``layers`` and ``experts_held`` (the chip's
    share), ``num_labels`` and ``seq_len`` (the rows' length, checked when
    given)."""

    supports_head_mode = True
    head_mode_regex = HEAD_REGEX

    def __init__(
        self,
        vocab_size: int = 65536,
        hidden_size: int = 2048,
        intermediate_size: int = 11776,
        moe_intermediate_size: int = 1536,
        num_attention_heads: int = 32,
        num_key_value_heads: int = 8,
        layer_types: Sequence[str] = ("conv", "conv", "full_attention", "conv"),
        num_dense_layers: int = 2,
        num_experts: int = 64,
        num_experts_per_tok: int = 4,
        norm_eps: float = 1e-5,
        conv_L_cache: int = 3,
        conv_bias: bool = False,
        norm_topk_prob: bool = True,
        routed_scaling_factor: float = 1.0,
        use_expert_bias: bool = True,
        rope_theta: Optional[float] = None,
        rope_parameters: Optional[dict] = None,
        num_hidden_layers: Optional[int] = None,
        max_position_embeddings: int = 128000,
        model_type: str = "lfm2_moe",
        layers: Optional[int] = None,
        experts_held: Optional[Sequence[int]] = None,
        num_labels: int = 5,
        seq_len: Optional[int] = None,
        compute_dtype: Optional[torch.dtype] = None,
        stream_dtype: Optional[torch.dtype] = None,
        dropout: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if conv_bias or dropout or model_type != "lfm2_moe":
            raise ValueError(f"an lfm2_moe model has no convolution bias and no dropout, "
                             f"not a {model_type!r} with conv_bias {conv_bias}, dropout {dropout}")
        theta = rope_theta if rope_theta is not None else (rope_parameters or {}).get(
            "rope_theta", 1e6)
        depth = layers if layers is not None else (num_hidden_layers or len(layer_types))
        kinds = list(layer_types)[:depth]
        if len(kinds) != depth or not set(kinds) <= set(LAYER_TYPES):
            raise ValueError(f"{depth} layers of the layer types {list(layer_types)}")
        self.dropout = 0.0
        self.seq_len = seq_len  # the rows' length, when the model is built for one
        self.max_positions = max_position_embeddings
        self.use_expert_bias = use_expert_bias
        self.stream_dtype, self.compute_dtype = stream_dtype, compute_dtype
        cfg = {"dtype": compute_dtype, "eps": norm_eps, "l_cache": conv_L_cache,
               "heads": num_attention_heads, "kv_heads": num_key_value_heads,
               "rope_theta": float(theta), "ffn": intermediate_size,
               "moe_ffn": moe_intermediate_size, "experts": num_experts,
               "top_k": num_experts_per_tok, "experts_held": experts_held,
               "norm_topk": norm_topk_prob, "scaling": float(routed_scaling_factor)}
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(vocab_size, hidden_size)
            self.model = Decoder([DecoderLayer(kind, i >= num_dense_layers, hidden_size, cfg)
                                  for i, kind in enumerate(kinds)])
            self.embedding_norm = RMSNorm(hidden_size, norm_eps)
            self.classifier = nn.Linear(hidden_size, num_labels)
        self.to_empty(device="cpu")
        for m in self.modules():  # ``to_empty`` left the buffers unset
            if isinstance(m, (Attention, MoE)):
                m.reset_buffers()
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Kernels N(0, 1/fan_in) (a projection's input width; the
        convolution's taps), norm scales 1, the embedding N(0, 0.02), the
        head's bias 0; drawn on the CPU from ``generator`` (seed 0 when
        None). The expert bias is zero."""
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name == "classifier.bias":
                p.zero_()
            elif name == "embed_tokens.weight":
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) / p.shape[-1] ** 0.5)
        for m in self.modules():
            if isinstance(m, MoE):
                m.expert_bias.zero_()

    @torch.no_grad()
    def set_expert_bias(self, bias: torch.Tensor) -> None:
        """Every MoE layer's expert bias (``num_experts``,), as aux-loss-free
        balancing would have moved it; it steers the selection only. A model
        without ``use_expert_bias`` keeps it zero."""
        if not self.use_expert_bias:
            raise ValueError("the model has no expert bias (use_expert_bias is false)")
        for m in self.modules():
            if isinstance(m, MoE):
                m.expert_bias.copy_(bias)

    def forward(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        """'full': (B, T) token ids -> logits; 'features': the final norm's
        (B, hidden) output at the last position; 'head': ``x`` is that ->
        logits. full(x) == head(features(x))."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        if mode == "head":
            return self._head(x)
        if x.shape[1] > self.max_positions or self.seq_len not in (None, x.shape[1]):
            raise ValueError(f"rows of {x.shape[1]} positions; the model takes "
                             f"{self.seq_len or f'up to {self.max_positions}'}")
        with span(FORWARD, device=True):
            h = self.embed_tokens(x)
            h = h if self.stream_dtype is None else h.to(self.stream_dtype)
            h = self.model(h)
            pooled = self.embedding_norm(h[:, -1])
        if mode == "features":
            return pooled
        return self._head(pooled)

    def _head(self, pooled: torch.Tensor) -> torch.Tensor:
        return F.linear(pooled.float(), self.classifier.weight, self.classifier.bias)
