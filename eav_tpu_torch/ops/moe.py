"""A mixture-of-experts feed-forward layer as one rank of expert parallelism
holds it: routed over every expert, computed for the experts it holds.

The layer (LFM2-MoE's, ``models/lfm2_moe.py``) on tokens u:

- scores s = sigmoid(W_r u) over all E experts (the router in float32);
- selection: the top k of s + b, b the expert bias (a buffer that steers
  the choice only, aux-loss-free balancing's; zero unless set);
- weights: s at the selected experts, w / (sum w + 1e-6) with
  ``norm_topk``, times ``scaling``;
- output: sum over the selected experts e of w_e SwiGLU_e(u), SwiGLU_e(u) =
  W2_e (silu(W1_e u) * W3_e u).

A rank holds ``experts_held`` of the E experts and computes their share of
the sum: the pairs (token, expert) that fall on a held expert. The shares of
disjoint sets of experts add up to the whole layer; the exchange of tokens
between ranks is not here. Nothing stands in for the experts it lacks.

The computation keeps fixed shapes and reads nothing back to the host, so a
training step stays one CUDA graph: the N·k pairs are sorted by held expert
(pairs on other experts last), the per-expert ends kept on the device
(``offs``), and the held pairs, however many, go through one grouped product
a projection (``grouped_mm``: ``torch._grouped_mm`` on the card, which
computes the rows below ``offs[-1]`` only). The room is N·k rows, so no
token is dropped whatever the balance. Rows past the held pairs hold no
result: they are masked (``torch.where``, whose gradient is nought there)
on the way in and on the way out, so that nothing of theirs reaches a token
or the router. (A gather from a zero row past the tokens would spare the
first mask, but its backward accumulates the room's other pairs, seven in
eight, into that one row one by one: 0.9 s a step on the H100.) The
combine is a weighted scatter-add of the rows into their tokens. While a
gradient is taken, the gather, the grouped products and the combine are
recomputed in the backward (``torch.utils.checkpoint``): the room's N·k
rows would otherwise keep five (N·k, width) tensors a layer for the
backward, 2.3 GB a layer at 32,768 tokens, for a recompute of about a
twentieth of the step's FLOPs.

Spans (``utils/profiling.span``, device-timed when not capturing):
``moe.route`` (scores, top-k and the grouping), ``moe.experts`` (the grouped
products) and ``moe.combine`` (the weighted scatter-add). The counter: a
device-resident tally of the pairs routed to each expert, held or not,
updated inside the step (a replayed graph counts too) and read by
``routed_pairs`` off the hot path.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eav_tpu_torch.utils.profiling import span

ROUTE, EXPERTS, COMBINE = "moe.route", "moe.experts", "moe.combine"

# (device, experts) -> int64 (experts,) pairs routed to each expert since the
# last ``routed_pairs(reset=True)``, over every layer of that width
_TALLY: Dict[tuple, torch.Tensor] = {}
_TALLY_LOCK = threading.Lock()


def _tally(device: torch.device, experts: int) -> torch.Tensor:
    key = (str(device), experts)
    with _TALLY_LOCK:
        t = _TALLY.get(key)
        if t is None:
            t = _TALLY[key] = torch.zeros(experts, dtype=torch.int64, device=device)
        return t


def routed_pairs(reset: bool = False) -> Dict[tuple, torch.Tensor]:
    """{(device, experts): (experts,) int64 on the CPU}: the (token, expert)
    pairs routed to each expert by every MoE layer since the last reset,
    held by this rank or not (each forward run on the device, a replayed
    graph's included). A host read: call it off the hot path, after a
    fence. ``reset`` zeroes the tallies."""
    with _TALLY_LOCK:
        out = {k: t.to("cpu", copy=True) for k, t in _TALLY.items()}
        if reset:
            for t in _TALLY.values():
                t.zero_()
    return out


class _SwiGLU(torch.autograd.Function):
    """silu(g) * up, keeping only g and up for the backward (autograd's
    own keeps silu(g) too); the backward is silu's own kernel
    (``silu_backward``) on grad * up, and grad * silu(g)."""

    @staticmethod
    def forward(g, up):
        return F.silu(g).mul_(up)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        g, up = ctx.saved_tensors
        return torch.ops.aten.silu_backward(grad * up, g), F.silu(g).mul_(grad)


def swiglu(g: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(g) * up (SwiGLU's gate), saving two tensors for the backward."""
    return _SwiGLU.apply(g, up)


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[g-1]:offs[g]`` of ``x`` (M, K) times ``w[g]`` (K, N), for
    each group g: (M, N), the rows past ``offs[-1]`` undefined. One grouped
    GEMM (``torch._grouped_mm``), with its backward."""
    return torch._grouped_mm(x, w, offs=offs)


class MoE(nn.Module):
    """The expert layer above, holding ``experts_held`` (expert ids, all of
    them when None). Parameters: ``gate.weight`` (E, hidden), the router,
    and ``w1``, ``w3`` (held, ffn, hidden), ``w2`` (held, hidden, ffn), the
    held experts' projections in their order; buffers, none of them in the
    state dict: ``expert_bias`` (E,) and ``local`` (each expert's place
    among the held ones, the number held when not held)."""

    def __init__(self, hidden: int, ffn: int, experts: int, top_k: int,
                 experts_held: Optional[Sequence[int]] = None, norm_topk: bool = True,
                 scaling: float = 1.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        held = list(range(experts)) if experts_held is None else [int(e) for e in experts_held]
        if len(set(held)) != len(held) or not all(0 <= e < experts for e in held) or not held:
            raise ValueError(f"experts_held must be distinct ids in [0, {experts}), got {held}")
        if not 1 <= top_k <= experts:
            raise ValueError(f"top_k {top_k} not in [1, {experts}]")
        self.experts, self.top_k, self.norm_topk, self.scaling = experts, top_k, norm_topk, scaling
        self.dtype, self.experts_held = dtype, held
        self.gate = nn.Linear(hidden, experts, bias=False)
        self.w1 = nn.Parameter(torch.empty(len(held), ffn, hidden))
        self.w3 = nn.Parameter(torch.empty(len(held), ffn, hidden))
        self.w2 = nn.Parameter(torch.empty(len(held), hidden, ffn))
        self.register_buffer("expert_bias", torch.empty(experts), persistent=False)
        self.register_buffer("local", torch.empty(experts, dtype=torch.int64), persistent=False)
        self.reset_buffers()

    @torch.no_grad()
    def reset_buffers(self) -> None:
        """The expert bias zero; ``local`` from ``experts_held``."""
        held = self.experts_held
        self.expert_bias.zero_()
        self.local.fill_(len(held))
        self.local[torch.tensor(held)] = torch.arange(len(held), device=self.local.device)

    def route(self, u: torch.Tensor):
        """(N, hidden) tokens -> (experts (N, k), weights (N, k) float32)."""
        scores = torch.sigmoid(F.linear(u.float(), self.gate.weight))
        idx = torch.topk(scores + self.expert_bias, self.top_k, dim=-1).indices
        w = scores.gather(1, idx)
        if self.norm_topk:
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
        return idx, w * self.scaling

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        """(..., hidden) -> (..., hidden): the held experts' share of the
        layer in ``dtype`` (u's when None), the experts' products in it; the
        router reads ``u`` in float32."""
        shape, n_held = u.shape, self.w1.shape[0]
        u = u.reshape(-1, shape[-1])
        k = self.top_k
        dtype = self.dtype or u.dtype
        with span(ROUTE, device=True):
            idx, w = self.route(u)
            pairs = idx.reshape(-1)  # pair p = token p // k, its (p % k)-th expert
            with torch.no_grad():
                _tally(u.device, self.experts).index_add_(
                    0, pairs, torch.ones_like(pairs))
            local = self.local[pairs]
            order = torch.sort(local, stable=True).indices  # by held expert, the others last
            counts = torch.zeros(n_held + 1, dtype=torch.int64, device=u.device)
            counts.scatter_add_(0, local, torch.ones_like(local))
            offs = counts[:n_held].cumsum(0).to(torch.int32)  # each held expert's end
            tok = order // k
            valid = (local[order] < n_held)[:, None]
            weight = w.reshape(-1)[order, None]
        args = (u.to(dtype), tok, valid, offs, weight)
        if torch.is_grad_enabled():
            out = checkpoint(self._experts, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            out = self._experts(*args)
        return out.reshape(shape)

    def _experts(self, u: torch.Tensor, tok: torch.Tensor, valid: torch.Tensor,
                 offs: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """The held pairs' rows through the grouped products, weighted and
        added into their tokens: (N, hidden) in ``u``'s dtype."""
        dtype = u.dtype
        with span(EXPERTS, device=True):
            x = torch.where(valid, u[tok], 0)
            g = grouped_mm(x, self.w1.to(dtype).transpose(1, 2), offs)
            up = grouped_mm(x, self.w3.to(dtype).transpose(1, 2), offs)
            y = grouped_mm(swiglu(g, up), self.w2.to(dtype).transpose(1, 2), offs)
        with span(COMBINE, device=True):
            y = torch.where(valid, y, 0) * weight.to(dtype)
            return torch.zeros_like(u).index_add(0, tok, y)
