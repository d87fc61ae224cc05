"""Flash attention: hand-written CUDA kernels for Hopper, with plain versions.

Four kernels (``csrc/flash_attention.cu``) replace the Pallas TPU kernels of
the JAX package (``eav_tpu/ops/pallas/attention.py`` and
``scripts/flash_onepass_experiment.py``):

- K1 ``flash_fwd``: O = softmax(Q K^T scale + bias) V by the online-softmax
  recurrence, and the per-row LSE = m + log l that the backward reads;
- K2 ``flash_dkv``: dK and dV, per K tile over all Q tiles;
- K3 ``flash_dq``: dQ, per Q tile over all K tiles;
- K5 ``flash_onepass``: the K1 forward as one K block, a plain softmax over
  each query row's whole score row (no online rescaling). The bf16 kernel
  recomputes the scores in a second sweep and takes any T; the float32
  kernel keeps a stripe of score rows in shared memory, which bounds its T
  (``onepass_max_len``).

Operands are head-major (BH, T, D) with ``t_real`` <= T real keys; the keys
past ``t_real`` are masked with -1e30 (exactly zero probability). The kernels
tile T by 64 and take any length, so the (B, T, H, D) API does not pad.
bfloat16 operands go through tensor-core (wgmma) kernels, float32 operands through
float32 FMA kernels; both accumulate in float32 with a float32 softmax state,
and P is rounded to V's type before P V and dS to Q's type before the dS
products, as on the TPU.

Each kernel has a plain PyTorch version (``*_plain``) with the same outputs
and the same rounding points. A wrapper runs the plain version for tensors on
the CPU and the CUDA kernel for tensors on a GPU; it never falls back from
one to the other. Each wrapper counts its kernel launches in ``.launches``,
under ``ops/build.LOCK`` (farm workers launch from several threads); a launch
captured into a CUDA graph is counted when the graph replays
(``tally_launches``, ``add_launches``).
``Di = rowsum(dO * O)`` stays plain PyTorch in float32, as it stayed XLA.

The copies between the (B, T, H, D) layout and the kernels' head-major one
(``_to_bh``, ``_fold``, dO made contiguous, and O's layout back in
``models/transformer.py``) run inside the span ``LAYOUT``, timed on the
card while a profiler runs (``utils/profiling.span``).

Under ``torch.func.vmap`` (a stacked fit, ``parallel/subject.py``) the
autograd functions fold the stack axis into the head-major one: S stacked
(BH, T, D) operands become one (S·BH, T, D) call, so one launch serves the
whole stack, as Pallas lifts a vmapped kernel's stack axis into its grid.
The kernels put B·H on ``blockIdx.y``, which CUDA caps at 65,535: the
wrappers refuse a larger B·H, folded or not.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from eav_tpu_torch.ops import build
from eav_tpu_torch.utils.profiling import span

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernels are built for
MAX_BH = 65535  # B·H lies on blockIdx.y, whose extent CUDA caps here
LAYOUT = "attention.layout"  # the span of the layout copies around the kernels
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "eav_flash_fwd": (_I, _I, _I) + (_VP,) * 5 + (_I, _I, _I, ctypes.c_float, _VP),
    "eav_flash_dkv": (_I, _I, _I) + (_VP,) * 8 + (_I, _I, _I, ctypes.c_float, _VP),
    "eav_flash_dq": (_I, _I, _I) + (_VP,) * 7 + (_I, _I, _I, ctypes.c_float, _VP),
    "eav_flash_onepass": (_I, _I, _I) + (_VP,) * 5 + (_I, _I, _I, ctypes.c_float, _VP),
}
# The float32 K5's carve-up of dynamic shared memory (csrc ``onepass_smem_f32``):
# a stripe of 32 query rows by t_real rounded up to 64 keys of float32 scores,
# padded by 16 floats a row, the rows' l, the Q stripe and one K or V tile. A
# block may have at most 227 KB.
ONEPASS_ROWS, ONEPASS_KTILE, SMEM_LIMIT = 32, 64, 232448


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library, built at first use, with typed entry points;
    under ``build.LOCK``, so two threads never both build or type it."""
    global _lib
    with build.LOCK:
        if _lib is None:
            lib = build.load("flash_attention")
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.eav_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.eav_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# the streams under ``tally_launches`` (by handle) -> {wrapper: launches captured}
_TALLIES: Dict[int, Dict] = {}


def _count(wrapper, stream: Optional[int] = None) -> None:
    """One launch of ``wrapper``'s kernel (``+=`` is not atomic across
    threads); on a stream under ``tally_launches``, counted in its tally
    instead."""
    with build.LOCK:
        tally = _TALLIES.get(stream)
        if tally is None:
            wrapper.launches += 1
        else:
            tally[wrapper] = tally.get(wrapper, 0) + 1


@contextlib.contextmanager
def tally_launches(stream: torch.cuda.Stream) -> Iterator[Dict]:
    """Inside the block, the kernels launched on ``stream`` (from any thread:
    the autograd engine's launches the backward) are counted into the
    yielded dict, {wrapper: launches}, and not into ``.launches``: a CUDA
    graph's capture, whose kernels run only when the graph replays
    (``add_launches``)."""
    tally: Dict = {}
    with build.LOCK:
        _TALLIES[stream.cuda_stream] = tally
    try:
        yield tally
    finally:
        with build.LOCK:
            del _TALLIES[stream.cuda_stream]


def add_launches(tally: Dict) -> None:
    """Count a tally's launches (a graph's replay runs them again)."""
    with build.LOCK:
        for wrapper, n in tally.items():
            wrapper.launches += n


def _scale(d: int) -> float:
    return float(1.0 / math.sqrt(d))


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain version), False for CUDA tensors (kernel);
    raises for anything else or a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"flash attention takes CPU or one CUDA device, got {sorted(kinds)}")


def _check_operands(q: torch.Tensor, *same: torch.Tensor) -> Tuple[int, int, int]:
    if q.dim() != 3:
        raise ValueError(f"expected (BH, T, D) operands, got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    for t in same:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError("q, k, v (and dO) must share shape and dtype")
    bh, t_pad, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not among the built kernels {HEAD_DIMS}")
    if bh > MAX_BH:
        raise ValueError(
            f"B·H = {bh} (a vmapped stack folds its subjects into it) is past the kernels' "
            f"grid limit of {MAX_BH} blocks on blockIdx.y: split the stack or the batch")
    return bh, t_pad, d


def _check_rows(bh: int, t_pad: int, *rows: torch.Tensor) -> None:
    for r in rows:
        if r.shape != (bh, t_pad) or r.dtype != torch.float32:
            raise ValueError(f"lse / di must be float32 ({bh}, {t_pad}), got {r.dtype} {tuple(r.shape)}")


def _launch(kernel, q: torch.Tensor, tensors, bh: int, t_pad: int, t_real: int) -> None:
    """Launch ``kernel``'s CUDA symbol (``eav_<name>``) on torch's current
    stream and count it."""
    symbol = f"eav_{kernel.__name__}"
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: operands must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{symbol}: bf16 operands must be 16-byte aligned")
    if not 1 <= t_real <= t_pad:
        raise ValueError(f"t_real={t_real} must lie in [1, {t_pad}]")
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, symbol)(
        q.device.index, _DTYPE_CODES[q.dtype], q.shape[-1],
        *(t.data_ptr() for t in tensors),
        bh, t_pad, t_real, _scale(q.shape[-1]), stream,
    )
    if rc != 0:
        msg = lib.eav_cuda_error_string(rc).decode()
        raise RuntimeError(f"{symbol} launch failed: {msg} ({rc})")
    _count(kernel, stream)


# -----------------------------------------------------------------------------
# Plain versions: the same functions in PyTorch, (T, T) scores in float32
# -----------------------------------------------------------------------------


def _key_bias(t_real: int, t_pad: int, device) -> torch.Tensor:
    """(t_pad,) float32: 0 for real keys, -1e30 for masked ones."""
    keep = torch.arange(t_pad, device=device) < t_real
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _scores(q, k, t_real):
    s = _scale(q.shape[-1]) * torch.matmul(q.float(), k.float().transpose(1, 2))
    return s + _key_bias(t_real, k.shape[1], q.device)


def flash_fwd_plain(q, k, v, t_real: int):
    """Plain K1: (o in q's dtype, lse (BH, T) float32)."""
    s = _scores(q, k, t_real)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, di, t_real):
    p = torch.exp(_scores(q, k, t_real) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = (p * (dp - di[..., None])).to(q.dtype).float()
    return p, ds


def flash_onepass_plain(q, k, v, t_real: int):
    """Plain K5, line by line the TPU body: (o in q's dtype, lse (BH, T)
    float32). The keys past ``t_real`` are replaced by -1e30 (``where``)."""
    s = _scale(q.shape[-1]) * torch.matmul(q.float(), k.float().transpose(1, 2))
    keep = torch.arange(k.shape[1], device=q.device) < t_real
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_dkv_plain(q, k, v, do, lse, di, t_real: int):
    """Plain K2: (dk, dv) in k's and v's dtype."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, di, t_real)
    dv = torch.matmul(p.to(do.dtype).float().transpose(1, 2), do.float())
    dk = _scale(q.shape[-1]) * torch.matmul(ds.transpose(1, 2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_plain(q, k, v, do, lse, di, t_real: int):
    """Plain K3: dq in q's dtype."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, di, t_real)
    return (_scale(q.shape[-1]) * torch.matmul(ds, k.float())).to(q.dtype)


# -----------------------------------------------------------------------------
# Kernel wrappers
# -----------------------------------------------------------------------------


def flash_fwd(q, k, v, t_real: int):
    """K1 (replaces ``_flash_kernel``, eav_tpu/ops/pallas/attention.py:73).
    q, k, v (BH, T, D) -> (o (BH, T, D), lse (BH, T) float32)."""
    bh, t_pad, _ = _check_operands(q, k, v)
    if _on_cpu(q, k, v):
        return flash_fwd_plain(q, k, v, t_real)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_pad), device=q.device, dtype=torch.float32)
    _launch(flash_fwd, q, (q, k, v, o, lse), bh, t_pad, t_real)
    return o, lse


def flash_dkv(q, k, v, do, lse, di, t_real: int):
    """K2 (replaces ``_dkv_kernel``, attention.py:113) -> (dk, dv)."""
    bh, t_pad, _ = _check_operands(q, k, v, do)
    _check_rows(bh, t_pad, lse, di)
    if _on_cpu(q, k, v, do, lse, di):
        return flash_dkv_plain(q, k, v, do, lse, di, t_real)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_dkv, q, (q, k, v, do, lse, di, dk, dv), bh, t_pad, t_real)
    return dk, dv


def flash_dq(q, k, v, do, lse, di, t_real: int):
    """K3 (replaces ``_dq_kernel``, attention.py:158) -> dq."""
    bh, t_pad, _ = _check_operands(q, k, v, do)
    _check_rows(bh, t_pad, lse, di)
    if _on_cpu(q, k, v, do, lse, di):
        return flash_dq_plain(q, k, v, do, lse, di, t_real)
    dq = torch.empty_like(q)
    _launch(flash_dq, q, (q, k, v, do, lse, di, dq), bh, t_pad, t_real)
    return dq


def onepass_smem_bytes(d: int, t_real: int) -> int:
    """The float32 K5's dynamic shared memory for ``t_real`` keys of head dim ``d``."""
    width = -(-t_real // ONEPASS_KTILE) * ONEPASS_KTILE
    return 4 * (ONEPASS_ROWS * (width + 16) + ONEPASS_ROWS
                + (ONEPASS_ROWS + ONEPASS_KTILE) * (d + 1))


def onepass_max_len(d: int) -> int:
    """The longest ``t_real`` whose float32 K5 stripe fits a block (1600 keys
    at head dim 64). The bf16 kernel keeps no stripe and takes any T."""
    t = ONEPASS_KTILE
    while onepass_smem_bytes(d, t + ONEPASS_KTILE) <= SMEM_LIMIT:
        t += ONEPASS_KTILE
    return t


def flash_onepass(q, k, v, t_real: int):
    """K5 (replaces ``_onepass_kernel``, scripts/flash_onepass_experiment.py:25).
    q, k, v (BH, T, D) -> (o (BH, T, D), lse (BH, T) float32). On the card,
    float32 ``t_real`` beyond ``onepass_max_len`` raises: the stripe would
    not fit."""
    bh, t_pad, d = _check_operands(q, k, v)
    if _on_cpu(q, k, v):
        return flash_onepass_plain(q, k, v, t_real)
    if q.dtype == torch.float32 and t_real > onepass_max_len(d):
        raise ValueError(
            f"flash_onepass: t_real={t_real} needs {onepass_smem_bytes(d, t_real)} "
            f"bytes of shared memory for its float32 score stripe, more than a block's "
            f"{SMEM_LIMIT}; the float32 kernel takes at most {onepass_max_len(d)} keys at D {d}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, t_pad), device=q.device, dtype=torch.float32)
    _launch(flash_onepass, q, (q, k, v, o, lse), bh, t_pad, t_real)
    return o, lse


flash_fwd.launches = 0
flash_dkv.launches = 0
flash_dq.launches = 0
flash_onepass.launches = 0
KERNELS = (flash_fwd, flash_dkv, flash_dq, flash_onepass)


def reset_launches() -> None:
    with build.LOCK:
        for fn in KERNELS:
            fn.launches = 0


# -----------------------------------------------------------------------------
# Autograd and the public layouts
# -----------------------------------------------------------------------------


def _fold(x: torch.Tensor, dim, size: int) -> torch.Tensor:
    """One operand of a vmapped call, (S, BH, ...) with its stack axis ``dim``
    (None: unbatched, expanded to the stack), as one contiguous (S·BH, ...)
    operand, subject by subject."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(size * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x: torch.Tensor, size: int) -> torch.Tensor:
    """(S·BH, ...) -> (S, BH, ...): ``_fold``'s inverse."""
    return x.view(size, x.shape[0] // size, *x.shape[1:])


class FlashAttention(torch.autograd.Function):
    """Attention on head-major (BH, T, D) operands -> (O, LSE): K1 forward,
    K2 and K3 backward (the JAX package's ``custom_vjp`` pair). LSE is
    returned (not differentiable) so that the backward can keep it: with a
    separate ``setup_context`` the function also runs under ``torch.func``'s
    ``vjp``, as a remat recompute (``models/transformer.Remat``) calls it.
    Its ``vmap`` rule folds the stack into B·H (the module docstring)."""

    @staticmethod
    def forward(q, k, v, t_real: int):
        return flash_fwd(q, k, v, t_real)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, t_real = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.t_real = t_real

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*FlashAttentionBackward.apply(q, k, v, o, lse, do, ctx.t_real), None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, t_real: int):
        s = info.batch_size
        with span(LAYOUT, device=True):
            folded = [_fold(x, d, s) for x, d in zip((q, k, v), in_dims)]
        o, lse = FlashAttention.apply(*folded, t_real)
        return (_unfold(o, s), _unfold(lse, s)), (0, 0)


class FlashAttentionBackward(torch.autograd.Function):
    """(q, k, v, O, LSE, dO) -> (dQ, dK, dV): rowsum(dO * O), then K2 and K3.
    A function of its own because under ``torch.func`` a backward sees the
    transform's wrapped tensors, which have no data pointer for a kernel;
    only a function's forward gets plain ones. Under vmap (a remat
    recompute's backward inside a stacked fit) it folds the stack as
    ``FlashAttention`` does, and Di is computed on the folded operands. Not
    differentiable again."""

    @staticmethod
    def forward(q, k, v, o, lse, do, t_real: int):
        with span(LAYOUT, device=True):
            do = do.contiguous()
        di = (do.float() * o.float()).sum(dim=-1)
        dk, dv = flash_dkv(q, k, v, do, lse, di, t_real)
        return flash_dq(q, k, v, do, lse, di, t_real), dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the flash attention backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, t_real: int):
        s = info.batch_size
        with span(LAYOUT, device=True):
            folded = [_fold(x, d, s) for x, d in zip((q, k, v, o, lse, do), in_dims)]
        grads = FlashAttentionBackward.apply(*folded, t_real)
        return tuple(_unfold(g, s) for g in grads), (0, 0, 0)


def flash_attention_bh(q, k, v, t_real: int):
    """q, k, v (BH, T_pad, D) with keys past ``t_real`` masked -> o, same layout."""
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), t_real)[0]


def _to_bh(x):
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def flash_attention(q, k, v):
    """Multi-head attention in the (B, T, H, D) layout, scale 1/sqrt(D)."""
    b, t, h, d = q.shape
    with span(LAYOUT, device=True):
        q, k, v = _to_bh(q), _to_bh(k), _to_bh(v)
    o = flash_attention_bh(q, k, v, t)
    return o.reshape(b, h, t, d).permute(0, 2, 1, 3)


def flash_onepass_attention(q, k, v):
    """The one-pass forward in the (B, T, H, D) layout, scale 1/sqrt(D): the
    counterpart of the experiment's ``onepass_forward``. Forward only."""
    b, t, h, d = q.shape
    with span(LAYOUT, device=True):
        q, k, v = _to_bh(q), _to_bh(k), _to_bh(v)
    o, _ = flash_onepass(q, k, v, t)
    return o.reshape(b, h, t, d).permute(0, 2, 1, 3)
