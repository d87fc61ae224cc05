"""The family ``lfm2_moe``: Liquid AI's LFM2-MoE (LFM2-8B-A1B, LFM2-24B-A2B),
a causal decoder of gated short convolutions and grouped-query attention
with a 64-expert layer, fine-tuned as EAV's classifier on the last position.

It gives the harness what ``harness.FAMILY`` names. The plain reference is
``benchmark/reference/lfm2_moe.py`` (float32, checkpointed); the arithmetic
is here:

- FLOPs a sample: every matmul over the row's T tokens, the routed experts
  counted nominally (k · held / E experts a token: the share of the k
  choices that falls on the experts held here when routing is even),
  causal attention as half the scores (QK^T and PV over the keys j <= i);
  the short convolutions' taps, norms, softmax and routing's top-k are
  elementwise and left out; a training sample is 3x the forward;
- kernel work: the flash kernels K1-K3 (``flash_fwd``, ``flash_dkv``,
  ``flash_dq``, as their launches are named) at (B·H, T, D) with half the
  FLOPs of the non-causal kernels (``yardstick.attention_work``) and the
  same bytes, one call an attention layer and batch; and the experts'
  grouped GEMMs (``EXPERT_GEMM``) of an MoE layer at the nominal T·k·held/E
  rows a sequence: 6 R·hidden·ffn FLOP forward (the gate, up and down
  projections), twice that again backward (the inputs' and the weights'
  gradients), each weight read once and each row operand read and
  written once.

Near-ties of the routing. The port's router reads the bf16 stream, so where
a token's k-th and (k+1)-th expert scores lie within that rounding the port
may choose the other: the token's whole contribution then moves from one
expert to another, and Adam's sign-like first steps carry it into both
experts' leaves. The reference breaks such near-ties as the port broke
them: ``hidden_module``, through which the driver reaches the port's model,
starts a record of the port's choices (``PortRoutes``), and the reference
takes a token's recorded choice where each of its experts scores within
``TIE`` of the token's k-th highest score in float32 (``reference.select``),
its own choice elsewhere. A choice further off than ``TIE`` is not taken,
so a router that chooses wrongly still reads as wrong.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from benchmark import yardstick
from benchmark.common import batches
from benchmark.reference import lfm2_moe as ref

FLASH = {"fwd": "flash_fwd", "dkv": "flash_dkv", "dq": "flash_dq"}
EXPERT_GEMM = "expert_gemm"  # the label of the experts' grouped GEMMs in a unit's work
BF16 = 2  # bytes
# the selection-score gap within which the reference takes the port's choice
# of experts: the near-ties the bf16 stream decides, 0.043 at most over two
# seeds' 8.6 M choices on the H100 (PERF.md section 2)
TIE = 0.05
SLOTS = 8  # training forwards whose choices are kept: the compared steps are the first
EVALS = 64  # evaluation forwards whose choices are kept


def _nominal_experts(model: dict) -> float:
    """Experts a token runs through here, on average under even routing."""
    return model["num_experts_per_tok"] * len(ref.held(model)) / model["num_experts"]


def param_shapes(model: dict) -> Dict[str, tuple]:
    return ref.param_shapes(model)


def forward_flops(model: dict) -> float:
    """Matmul FLOPs of one sample's forward (the module docstring)."""
    t, h = model["seq_len"], model["hidden_size"]
    heads, kv = model["num_attention_heads"], model["num_key_value_heads"]
    d = h // heads
    per_token = 0.0
    for op, moe in ref.layer_plan(model):
        if op == "conv":
            per_token += 2 * (h * 3 * h + h * h)
        else:
            per_token += 2 * (h * heads * d + 2 * h * kv * d + heads * d * h)
            per_token += 2 * t * heads * d  # 4 T D a head over the keys, causal half
        if moe:
            per_token += 2 * h * model["num_experts"]
            per_token += _nominal_experts(model) * 6 * h * model["moe_intermediate_size"]
        else:
            per_token += 6 * h * model["intermediate_size"]
    return float(t * per_token + 2 * h * model.get("num_labels", 5))


def train_flops(model: dict) -> float:
    return 3.0 * forward_flops(model)


def expert_work(model: dict, rows: float, train: bool) -> Tuple[float, float]:
    """(FLOP, bytes) of one MoE layer's grouped GEMMs over ``rows`` routed
    rows: forward, and with ``train`` the backward too."""
    h, f, n = model["hidden_size"], model["moe_intermediate_size"], len(ref.held(model))
    weights = 3 * n * h * f * BF16
    acts = rows * (2 * h + 2 * f + f + f + h) * BF16  # x twice, gate and up out, h in, y out
    flop, nbytes = 6 * rows * h * f, weights + acts
    if train:  # dX and dW of each projection: operands read again, gradients written
        flop, nbytes = 3 * flop, nbytes + 2 * acts + 2 * weights
    return flop, nbytes


def kernel_work(model: dict, sizes: List[int], train: bool) -> List[Tuple[str, float, float, int]]:
    """[(kernel, FLOP, bytes, calls)] of one pass over batches of ``sizes``
    (the module docstring)."""
    t, heads = model["seq_len"], model["num_attention_heads"]
    d = model["hidden_size"] // heads
    plan = ref.layer_plan(model)
    attn = sum(1 for op, _ in plan if op == "full_attention")
    moes = sum(1 for _, moe in plan if moe)
    out = []
    for b, n in sorted(Counter(sizes).items()):
        for k in ("fwd", "dkv", "dq") if train else ("fwd",):
            flop, nbytes = yardstick.attention_work(k, b * heads, t, d)
            out.append((FLASH[k], flop / 2, nbytes, n * attn))
        rows = b * t * _nominal_experts(model)
        out.append((EXPERT_GEMM, *expert_work(model, rows, train), n * moes))
    return out


def reference_blocks(model: dict, n: int) -> List[Tuple[int, int]]:
    """The reference's forward over ``n`` rows in blocks of 4 rows (32,768
    tokens: the dense layers' float32 intermediates, 1.5 GB each, bound it)."""
    return batches(n, 4)


class PortRoutes:
    """The port's expert choices, recorded as its model runs.

    Training forwards (a gradient taken: eager, captured into a CUDA graph
    or replayed, so device writes only, at a slot a device count of the
    forwards picks): the first ``SLOTS`` forwards' token ids and each MoE
    layer's (N, k) choices; later forwards write a spare slot. Evaluation
    forwards (eager, without a gradient): the first ``EVALS`` forwards' ids,
    choices and the head's bias at the time, which tells the weights the
    choices were made with. A few small copies a forward; nothing is read
    back to the host until the reference asks (``given``)."""

    def __init__(self, model):
        moes = [m for m in model.modules() if type(m).__name__ == "MoE"]
        self.layers, self.k = len(moes), moes[0].top_k
        self.bias = model.classifier.bias  # the model's modules are not held: they go with it
        self.slots, self.current, self.evals = SLOTS, None, []
        self.count = self.ids = self.tokens = self.choices = None
        embed, inner = model.embed_tokens, model.embed_tokens.forward
        embed.forward = lambda ids: (self._begin(ids), inner(ids))[1]
        for layer, m in enumerate(moes):
            m.route = lambda u, route=m.route, layer=layer: self._record(layer, *route(u))

    def _begin(self, ids: torch.Tensor) -> None:
        self.current = None
        if not torch.is_grad_enabled():
            if len(self.evals) < EVALS:
                self.current = {"ids": ids.detach().clone(), "bias": self.bias.detach().clone(),
                                "choices": []}
                self.evals.append(self.current)
            return
        n, k = ids.numel(), self.k
        if self.ids is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                return  # no buffers made inside a capture
            dev = ids.device
            self.count = torch.zeros((), dtype=torch.int64, device=dev)
            self.ids = torch.zeros(self.slots + 1, n, dtype=torch.int64, device=dev)
            self.tokens = torch.zeros(self.slots + 1, dtype=torch.int64, device=dev)
            self.choices = torch.zeros(self.slots + 1, self.layers, n * k, dtype=torch.int8,
                                       device=dev)
        if n > self.ids.shape[1]:
            return
        slot = self.count.clamp(max=self.slots).view(1)
        self.ids[:, :n].index_copy_(0, slot, ids.reshape(1, -1))
        self.tokens.index_fill_(0, slot, n)
        self.current = slot

    def _record(self, layer: int, idx: torch.Tensor, w: torch.Tensor):
        cur = self.current
        if isinstance(cur, dict):
            cur["choices"].append(idx.to(torch.int8))
        elif cur is not None:
            self.choices[:, layer, :idx.numel()].index_copy_(
                0, cur, idx.reshape(1, -1).to(torch.int8))
            if layer == self.layers - 1:
                self.count.add_(1)
        if layer == self.layers - 1:
            self.current = None
        return idx, w

    def given(self, ids: torch.Tensor, params: dict) -> Optional[List[torch.Tensor]]:
        """Each MoE layer's (B·T, k) choices of the port for the rows
        ``ids``: a training forward's on the same batch, else each row's
        from an evaluation forward with the head's bias of ``params`` (-1,
        taken by no token, where a row has none); None when nothing fits."""
        n, k = ids.numel(), self.k
        if self.ids is not None and n <= self.ids.shape[1]:
            flat = ids.reshape(-1).to(self.ids.device)
            for j in range(self.slots):
                if int(self.tokens[j]) == n and torch.equal(self.ids[j, :n], flat):
                    return [c.view(-1, k) for c in self.choices[j, :, :n * k]]
        bias = params["classifier.bias"].detach()
        rows = [(e, i) for e in self.evals if len(e["choices"]) == self.layers
                and torch.equal(e["bias"], bias.to(e["bias"].device)) for i in range(len(e["ids"]))]
        out = [torch.full((n, k), -1, dtype=torch.int8, device=ids.device)
               for _ in range(self.layers)]
        found = False
        for r, row in enumerate(ids):
            hit = next(((e, i) for e, i in rows if torch.equal(e["ids"][i], row)), None)
            if hit is None:
                continue
            found, (e, i), t = True, hit, ids.shape[1]
            for o, c in zip(out, e["choices"]):
                o[r * t:(r + 1) * t] = c.view(-1, t, k)[i]
        return out if found else None


_PORT: Dict[str, Optional[PortRoutes]] = {"routes": None}


def _routes(x, params) -> dict:
    """``reference.hidden``'s keywords: the port's recorded choices for
    the rows ``x``, when there are any, and ``TIE``."""
    port = _PORT["routes"]
    return {"routes": None if port is None else port.given(x, params), "tie": TIE}


def hidden(x, params, model: dict, precision: str = "float32"):
    return ref.hidden(x, params, model, precision, **_routes(x, params))


def pool(h, params, model: dict):
    return ref.pool(h, params, model)


def head(pooled, params, model: dict, precision: str = "float32"):
    return ref.head(pooled, params, model, precision)


def features(x, params, model: dict, precision: str = "float32"):
    return ref.features(x, params, model, precision, **_routes(x, params))


def logits(x, params, model: dict, precision: str = "float32"):
    return ref.logits(x, params, model, precision, **_routes(x, params))


def hidden_module(model):
    """The port's decoder stack, whose output is the last layer's, before
    ``embedding_norm``. From here on the port's expert choices are recorded
    (``PortRoutes``) for the reference's near-ties."""
    _PORT["routes"] = PortRoutes(model)
    return model.model
