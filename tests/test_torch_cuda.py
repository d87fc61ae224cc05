"""The CUDA flash-attention kernels (K1-K3 and the one-pass K5) against their
plain versions on the card.

These need a GPU with the CUDA toolkit (the kernels are built with nvcc at
first use), so they carry the ``cuda`` marker and skip elsewhere. Run them on
a GPU host with ``python -m pytest tests/test_torch_cuda.py``.
"""

import pytest
import torch

from eav_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the flash kernels have no CPU mode")
    return torch.device("cuda")


# (atol, rtol) for O, dQ, dK, dV and for the float32 LSE: bf16 outputs differ
# from the plain versions by an ulp or two where the sum order differs
TOL = {torch.float32: ((2e-4, 2e-4), (2e-4, 2e-4)),
       torch.bfloat16: ((1e-2, 2e-2), (1e-4, 1e-4))}


def _outputs(q, k, v, do, t_real, plain, mask=None):
    """(o, lse, dk, dv, dq) of the kernels or of the plain versions with the
    keys past ``mask`` (default ``t_real``) masked; the backward is fed the
    plain forward's lse and rowsum(dO * O) at ``t_real`` either way."""
    mask = t_real if mask is None else mask
    o_p, lse_p = A.flash_fwd_plain(q, k, v, t_real)
    di = (do.float() * o_p.float()).sum(-1)
    fwd, dkv, dq = ((A.flash_fwd_plain, A.flash_dkv_plain, A.flash_dq_plain) if plain
                    else (A.flash_fwd, A.flash_dkv, A.flash_dq))
    return (*fwd(q, k, v, mask), *dkv(q, k, v, do, lse_p, di, mask),
            dq(q, k, v, do, lse_p, di, mask))


def _tol(dtype, i):
    """assert_close tolerance of output ``i`` of ``_outputs`` (1 is the LSE)."""
    atol, rtol = TOL[dtype][1 if i == 1 else 0]
    return dict(atol=atol, rtol=rtol)


def _inputs(cuda, dtype, d, t_pad):
    gen = torch.Generator(device=cuda).manual_seed(d + t_pad)
    return [torch.randn(6, t_pad, d, generator=gen, device=cuda).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
@pytest.mark.parametrize("t_pad,t_real", [(197, 197), (256, 200), (65, 1), (1214, 1214),
                                           (1280, 1214), (300, 300)])
def test_kernels_match_plain(cuda, dtype, d, t_pad, t_real):
    q, k, v, do = _inputs(cuda, dtype, d, t_pad)
    got = _outputs(q, k, v, do, t_real, plain=False)
    want = _outputs(q, k, v, do, t_real, plain=True)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.float(), w.float(), **_tol(dtype, i))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tolerance_rejects_a_mask_one_key_short(cuda, dtype):
    """A planted fault: the plain versions with the last real key masked.
    Each kernel output must fail the check above against them."""
    q, k, v, do = _inputs(cuda, dtype, 64, 256)
    got = _outputs(q, k, v, do, 200, plain=False)
    wrong = _outputs(q, k, v, do, 200, plain=True, mask=199)
    for i, (g, w) in enumerate(zip(got, wrong)):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(g.float(), w.float(), **_tol(dtype, i))


def test_launches_are_counted(cuda):
    A.reset_launches()
    x = torch.randn(2, 64, 64, device=cuda, requires_grad=True)
    A.flash_attention_bh(x, x, x, 64).sum().backward()
    A.flash_onepass(x.detach(), x.detach(), x.detach(), 64)
    assert [fn.launches for fn in A.KERNELS] == [1, 1, 1, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", A.HEAD_DIMS)
@pytest.mark.parametrize("t_pad,t_real", [(1214, 1214), (197, 197), (256, 200), (65, 1), (33, 33)])
def test_onepass_matches_plain(cuda, dtype, d, t_pad, t_real):
    q, k, v, _ = _inputs(cuda, dtype, d, t_pad)
    o, lse = A.flash_onepass(q, k, v, t_real)
    o_p, lse_p = A.flash_onepass_plain(q, k, v, t_real)
    torch.testing.assert_close(o.float(), o_p.float(), **_tol(dtype, 0))
    torch.testing.assert_close(lse, lse_p, **_tol(dtype, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onepass_tolerance_rejects_a_mask_one_key_short(cuda, dtype):
    q, k, v, _ = _inputs(cuda, dtype, 64, 1214)
    o, lse = A.flash_onepass(q, k, v, 1214)
    o_f, lse_f = A.flash_onepass_plain(q, k, v, 1213)
    for i, (g, w) in enumerate(((o, o_f), (lse, lse_f))):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(g.float(), w.float(), **_tol(dtype, i))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onepass_refuses_a_stripe_past_shared_memory(cuda, dtype):
    """float32 keeps a stripe of score rows in shared memory: the longest T
    whose stripe fits runs, one tile more raises before any launch. bf16
    keeps none: it runs past that length (T 2048, 2000 real keys) and
    matches its plain version."""
    A.reset_launches()
    if dtype == torch.bfloat16:
        q, k, v, _ = _inputs(cuda, dtype, 64, 2048)
        o, lse = A.flash_onepass(q, k, v, 2000)
        o_p, lse_p = A.flash_onepass_plain(q, k, v, 2000)
        torch.testing.assert_close(o.float(), o_p.float(), **_tol(dtype, 0))
        torch.testing.assert_close(lse, lse_p, **_tol(dtype, 1))
        assert A.flash_onepass.launches == 1
        return
    t_max = A.onepass_max_len(64)
    q, k, v, _ = _inputs(cuda, dtype, 64, t_max + 64)
    o, _ = A.flash_onepass(q, k, v, t_max)
    torch.testing.assert_close(o.float(), A.flash_onepass_plain(q, k, v, t_max)[0].float(),
                               **_tol(dtype, 0))
    with pytest.raises(ValueError, match="shared memory"):
        A.flash_onepass(q, k, v, t_max + 1)
    assert A.flash_onepass.launches == 1
