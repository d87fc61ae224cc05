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
(pairs on other experts last) into a room of N·k rows, so no token is
dropped whatever the balance; the per-expert ends stay on the device
(``offs``; the held count is ``offs[-1]``), and the held pairs, however
many, go through one grouped product a projection (``grouped_mm``:
``torch._grouped_mm`` on the card, which computes the rows below
``offs[-1]`` only). The row passes over the room stop at the held count too,
which they read on the device (``csrc/moe.cu``): ``dispatch`` copies each
held pair's token into its room row, ``room_swiglu`` gates the held rows,
and ``combine`` sums each token's weighted held rows into it, in float32 and
written once. Their backwards are kernels too: a per-token gather-reduce of
the rows' gradients (no atomics), SwiGLU's, and the combine's row gradients
with each pair's weight gradient (zero for pairs not held). Rows at or past
the held count are neither read nor written by any of them, so nothing of
theirs reaches a token or the router. ``order`` (int32) is the pair in each
room row and ``slot`` (int32) its inverse, the room row of each pair. Each
kernel has a plain PyTorch version (``*_plain``) that the wrappers run for
CPU tensors; a CUDA tensor always takes the kernel. Each wrapper counts its
launches in ``.launches`` (``KERNELS``; a CUDA graph's replays counted as
``ops/attention.tally_launches`` says). While a gradient is taken, the
dispatch, the grouped products, the SwiGLU and the combine are recomputed in
the backward (``torch.utils.checkpoint``): the room's N·k rows would
otherwise keep five (N·k, width) tensors a layer for the backward, 2.3 GB a
layer at 32,768 tokens, for a recompute of about a twentieth of the step's
FLOPs.

Spans (``utils/profiling.span``, device-timed when not capturing):
``moe.route`` (scores, top-k and the grouping), ``moe.experts`` (the
dispatch, the grouped products and the room's SwiGLU) and ``moe.combine``
(the weighted sum into the tokens). The counter: a device-resident tally of
the pairs routed to each expert, held or not, updated inside the step (a
replayed graph counts too) and read by ``routed_pairs`` off the hot path.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from eav_tpu_torch.ops import build
from eav_tpu_torch.ops.attention import _count
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


# -----------------------------------------------------------------------------
# The room's row passes: kernels (csrc/moe.cu) and their plain versions
# -----------------------------------------------------------------------------

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {  # device, dtype, pointers and sizes, the stream
    "eav_moe_dispatch": (_I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP),
    "eav_moe_dispatch_bwd": (_I, _I, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP),
    "eav_moe_swiglu": (_I, _I, _VP, _VP, _VP, _I, _I, _I, _VP, _VP),
    "eav_moe_swiglu_bwd": (_I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP),
    "eav_moe_combine": (_I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP),
    "eav_moe_combine_bwd": (_I, _I, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP),
}

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with typed entry points."""
    global _lib
    with build.LOCK:
        if _lib is None:
            lib = build.load("moe")
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.eav_moe_error_string.argtypes = (ctypes.c_int,)
            lib.eav_moe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for tensors on one CUDA
    device (kernel); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError(f"the MoE row passes take CPU or one CUDA device, got {devices}")
    return next(iter(devices)).type == "cpu"


def _check(rows: torch.Tensor, *same: torch.Tensor) -> None:
    """(rows, width) row tensors of one float type, rows of 16-byte multiples."""
    if rows.dtype not in _DTYPE_CODES or rows.dim() != 2:
        raise ValueError(f"expected (rows, width) float32 or bfloat16, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[1] * rows.element_size() % 16:
        raise ValueError(f"a row of {rows.shape[1]} {rows.dtype} is not a multiple of 16 bytes")
    for t in same:
        if t.dtype != rows.dtype or t.dim() != 2 or t.shape[1] != rows.shape[1]:
            raise ValueError("row operands must share type and width")


def _check_room(offs: torch.Tensor, *indices: torch.Tensor) -> None:
    if offs.dtype != torch.int32 or offs.numel() < 1 or any(
            t.dtype != torch.int32 for t in indices):
        raise ValueError("offs (not empty), order and slot must be int32")


def _check_weights(w: torch.Tensor, slot: torch.Tensor) -> None:
    if w.dtype != torch.float32 or w.dim() != 2 or w.numel() != slot.numel():
        raise ValueError("the pairs' weights must be float32 (N, k), one a pair")


def _launch(wrapper, symbol: str, ins, sizes, outs) -> None:
    """Launch ``symbol`` on torch's current stream with the pointers of
    ``ins``, then ``sizes``, then the pointers of ``outs``, in the row type of
    ``ins[0]``; count it on ``wrapper``."""
    for t in (*ins, *outs):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{symbol}: operands must be contiguous and 16-byte aligned")
    lib = _library()
    dev = ins[0].device
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, symbol)(dev.index, _DTYPE_CODES[ins[0].dtype],
                              *(t.data_ptr() for t in ins), *sizes,
                              *(t.data_ptr() for t in outs), stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed: {lib.eav_moe_error_string(rc).decode()} "
                           f"({rc})")
    _count(wrapper, stream)


def room_empty(rows: int, width: int, like: torch.Tensor) -> torch.Tensor:
    """A room-sized output, (rows, width) of ``like``'s type and device, left
    as allocated: the rows past the held count are never written."""
    return like.new_empty(rows, width)


def _held(offs: torch.Tensor) -> int:
    return int(offs[-1])


def dispatch_plain(u, order, offs, k: int):
    x = room_empty(order.numel(), u.shape[1], u)
    c = _held(offs)
    x[:c] = u[order[:c].long() // k]
    return x


def dispatch_backward_plain(dx, slot, offs, k: int):
    s = slot.long().view(-1, k)
    held = s < _held(offs)
    rows = dx.new_zeros(*s.shape, dx.shape[1], dtype=torch.float32)
    rows[held] = dx[s[held]].float()
    return rows.sum(1).to(dx.dtype)


def room_swiglu_plain(g, up, offs):
    h, c = room_empty(*g.shape, g), _held(offs)
    h[:c] = F.silu(g[:c]) * up[:c]
    return h


def room_swiglu_backward_plain(dh, g, up, offs):
    dg, dup, c = room_empty(*g.shape, g), room_empty(*g.shape, g), _held(offs)
    dg[:c] = torch.ops.aten.silu_backward(dh[:c] * up[:c], g[:c])
    dup[:c] = F.silu(g[:c]) * dh[:c]
    return dg, dup


def combine_plain(y, w, slot, offs):
    s = slot.long().view(w.shape)
    held = s < _held(offs)
    rows = y.new_zeros(*s.shape, y.shape[1], dtype=torch.float32)
    rows[held] = y[s[held]].float() * w[held][:, None]
    return rows.sum(1).to(y.dtype)


def combine_backward_plain(dout, y, w, slot, offs):
    s = slot.long().view(w.shape)
    held = s < _held(offs)
    d = dout.float()[:, None, :].expand(*s.shape, dout.shape[1])[held]
    dy, dw = room_empty(*y.shape, y), torch.zeros_like(w)
    dy[s[held]] = (w[held][:, None] * d).to(y.dtype)
    dw[held] = (y[s[held]].float() * d).sum(-1)
    return dy, dw


def dispatch(u, order, offs, k: int):
    """u (N, width), order (N·k,) int32, offs (held,) int32 -> x (N·k,
    width): x[r] = u[order[r] // k] for the room rows r < offs[-1]."""
    _check(u)
    _check_room(offs, order)
    if _on_cpu(u, order, offs):
        return dispatch_plain(u, order, offs, k)
    x = room_empty(order.numel(), u.shape[1], u)
    _launch(dispatch, "eav_moe_dispatch", (u, order, offs),
            (offs.numel(), k, order.numel(), u.shape[1]), (x,))
    return x


def dispatch_backward(dx, slot, offs, k: int):
    """dx (N·k, width), slot (N·k,) int32 -> du (N, width): each token's
    held pairs' rows summed in float32, zero where it has none."""
    _check(dx)
    _check_room(offs, slot)
    if _on_cpu(dx, slot, offs):
        return dispatch_backward_plain(dx, slot, offs, k)
    tokens = slot.numel() // k
    du = dx.new_empty(tokens, dx.shape[1])
    _launch(dispatch_backward, "eav_moe_dispatch_bwd", (dx, slot, offs),
            (offs.numel(), k, tokens, dx.shape[1]), (du,))
    return du


def room_swiglu(g, up, offs):
    """silu(g) * up over the room rows below offs[-1] (N·k, ffn)."""
    _check(g, up)
    _check_room(offs)
    if _on_cpu(g, up, offs):
        return room_swiglu_plain(g, up, offs)
    h = room_empty(*g.shape, g)
    _launch(room_swiglu, "eav_moe_swiglu", (g, up, offs), (offs.numel(), *g.shape), (h,))
    return h


def room_swiglu_backward(dh, g, up, offs):
    """(dg, dup) of ``room_swiglu`` over the rows below offs[-1]."""
    _check(dh, g, up)
    _check_room(offs)
    if _on_cpu(dh, g, up, offs):
        return room_swiglu_backward_plain(dh, g, up, offs)
    dg, dup = room_empty(*g.shape, g), room_empty(*g.shape, g)
    _launch(room_swiglu_backward, "eav_moe_swiglu_bwd", (dh, g, up, offs),
            (offs.numel(), *g.shape), (dg, dup))
    return dg, dup


def combine(y, w, slot, offs):
    """y (N·k, width), w (N, k) float32, slot (N·k,) int32 -> out (N, width)
    in y's type: out[n] = sum_j w[n, j] y[slot[n·k + j]] over the held pairs,
    in float32, zero for a token with none."""
    _check(y)
    _check_room(offs, slot)
    _check_weights(w, slot)
    if _on_cpu(y, w, slot, offs):
        return combine_plain(y, w, slot, offs)
    out = y.new_empty(w.shape[0], y.shape[1])
    _launch(combine, "eav_moe_combine", (y, w, slot, offs),
            (offs.numel(), w.shape[1], w.shape[0], y.shape[1]), (out,))
    return out


def combine_backward(dout, y, w, slot, offs):
    """(dy, dw) of ``combine``: dy[slot] = w dout[n] for the held pairs
    (rows past offs[-1] unwritten), dw[n, j] = <y[slot], dout[n]> for the
    held pairs and 0 for the others."""
    _check(dout, y)
    _check_room(offs, slot)
    _check_weights(w, slot)
    if _on_cpu(dout, y, w, slot, offs):
        return combine_backward_plain(dout, y, w, slot, offs)
    dy, dw = room_empty(*y.shape, y), torch.empty_like(w)
    _launch(combine_backward, "eav_moe_combine_bwd", (dout, y, w, slot, offs),
            (offs.numel(), w.shape[1], w.shape[0], y.shape[1]), (dy, dw))
    return dy, dw


KERNELS = (dispatch, dispatch_backward, room_swiglu, room_swiglu_backward, combine,
           combine_backward)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launches() -> None:
    with build.LOCK:
        for fn in KERNELS:
            fn.launches = 0


class Dispatch(torch.autograd.Function):
    """``dispatch`` with ``dispatch_backward`` as its gradient."""

    @staticmethod
    def forward(u, order, slot, offs, k: int):
        return dispatch(u, order, offs, k)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, slot, offs, ctx.k = inputs
        ctx.save_for_backward(slot, offs)

    @staticmethod
    def backward(ctx, dx):
        slot, offs = ctx.saved_tensors
        return dispatch_backward(dx.contiguous(), slot, offs, ctx.k), None, None, None, None


class RoomSwiGLU(torch.autograd.Function):
    """``room_swiglu`` with ``room_swiglu_backward`` as its gradient."""

    @staticmethod
    def forward(g, up, offs):
        return room_swiglu(g, up, offs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dh):
        g, up, offs = ctx.saved_tensors
        return (*room_swiglu_backward(dh.contiguous(), g, up, offs), None)


class Combine(torch.autograd.Function):
    """``combine`` with ``combine_backward`` as its gradient (y's and w's)."""

    @staticmethod
    def forward(y, w, slot, offs):
        return combine(y, w, slot, offs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, dout):
        y, w, slot, offs = ctx.saved_tensors
        return (*combine_backward(dout.contiguous(), y, w, slot, offs), None, None)


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
            rows = torch.arange(order.numel(), dtype=torch.int32, device=u.device)
            slot = torch.empty_like(rows).scatter_(0, order, rows)  # each pair's room row
            order = order.to(torch.int32)
        args = (u.to(dtype), order, slot, offs, w)
        if torch.is_grad_enabled():
            out = checkpoint(self._experts, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            out = self._experts(*args)
        return out.reshape(shape)

    def _experts(self, u: torch.Tensor, order: torch.Tensor, slot: torch.Tensor,
                 offs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The held pairs' rows through the grouped products, weighted and
        summed into their tokens: (N, hidden) in ``u``'s dtype."""
        dtype = u.dtype
        with span(EXPERTS, device=True):
            x = Dispatch.apply(u, order, slot, offs, self.top_k)
            g = grouped_mm(x, self.w1.to(dtype).transpose(1, 2), offs)
            up = grouped_mm(x, self.w3.to(dtype).transpose(1, 2), offs)
            y = grouped_mm(RoomSwiGLU.apply(g, up, offs), self.w2.to(dtype).transpose(1, 2), offs)
        with span(COMBINE, device=True):
            return Combine.apply(y, w, slot, offs)
