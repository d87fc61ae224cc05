"""The CUDA flash-attention kernels (K1-K3 and the one-pass K5) against their
plain versions on the card, a fit that repeats bit for bit on the card under
the trainer's deterministic mode, and the fifth slice on the card: the
scnn180 chain against float64 on the CPU, ResNetAttn's forward against the
CPU, and an HF checkpoint round trip.

These need a GPU with the CUDA toolkit (the kernels are built with nvcc at
first use), so they carry the ``cuda`` marker and skip elsewhere. Run them on
a GPU host with ``python -m pytest tests/test_torch_cuda.py``.
"""

import os

# cuBLAS is deterministic only with this workspace setting in place before the
# process's first cuBLAS call, which an earlier test here may make; it has no
# effect without a GPU
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from eav_tpu_torch.ops import attention as A  # noqa: E402

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


def test_deterministic_fit_repeats_on_the_card(cuda):
    """A tiny conformer, dropout 0.5, shuffled batches: two fits under one
    seed in the deterministic mode give the same history and test logits,
    bit for bit."""
    from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
    from eav_tpu_torch.models.conformer_eeg import ConformerEEG
    from eav_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    data = (rng.normal(size=(20, 4, 100)).astype(np.float32), rng.integers(0, 5, 20),
            rng.normal(size=(8, 4, 100)).astype(np.float32), rng.integers(0, 5, 8))
    cfg = FinetuneConfig(model="conformer_eeg", batch_size=8, optimizer="adam",
                         weight_decay=0.0, phases=(PhaseConfig(3, 1e-3, False),),
                         compat_softmax=True)
    trainer = Trainer(ConformerEEG(chans=4, samples=100, num_layers=2, dropout=0.5), cfg,
                      device=cuda, deterministic=True)
    a, b = trainer.fit(data, seed=3), trainer.fit(data, seed=3)
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_array_equal(a.history[k], b.history[k], err_msg=k)
    np.testing.assert_array_equal(a.outputs_test, b.outputs_test)


@pytest.mark.parametrize("remat", ["attn", "full"])
def test_remat_recomputes_through_the_kernels(cuda, remat):
    """A tiny AST with flash attention and dropout: the remat recompute runs
    K1 again under ``torch.func.vjp`` and K2/K3 in its backward, and every
    gradient equals that of the run that keeps its activations."""
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.models.dropout import set_generator

    x = torch.randn(2, 128, 128, generator=torch.Generator(device=cuda).manual_seed(0),
                    device=cuda)
    grads, launches = [], []
    for mode in ("none", remat):
        m = ast_tiny(dropout=0.3, attn_impl="flash", remat=mode).to(cuda).train()
        set_generator(m, torch.Generator(device=cuda).manual_seed(7))
        A.reset_launches()
        m(x).square().sum().backward()
        launches.append([fn.launches for fn in A.KERNELS])
        grads.append({n: p.grad for n, p in m.named_parameters()})
    assert launches[0][1:3] == launches[1][1:3] != [0, 0]
    assert launches[1][0] > launches[0][0]  # the recompute's forwards
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5, atol=1e-5)


@pytest.fixture
def no_tf32():
    """float32 means float32: TF32 off for matmuls and cuDNN, then restored."""
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_scnn180_chain_on_the_card(cuda, no_tf32):
    """The 180-d features of 16 noisy harmonic 5 s clips in float32 on the
    card against float64 on the CPU: tuning indices equal, each block within
    2e-4 of its scale."""
    from eav_tpu_torch.ops import spectral as S

    rng = np.random.default_rng(0)
    t = np.arange(5 * 22050) / 22050
    y = np.stack([sum(np.sin(2 * np.pi * f0 * k * t) / k for k in range(1, 5))
                  + 0.1 * rng.standard_normal(t.size)
                  for f0 in rng.uniform(100, 400, 16)]).astype(np.float32)
    x = torch.from_numpy(y)
    got = S.scnn180_features(x.to(cuda), 22050).cpu().numpy()
    want = S.scnn180_features(x.double(), 22050).numpy()
    idx = S.estimate_tuning_power(S.stft_mag_sq(x.to(cuda)), 22050, 2048).cpu()
    idx64 = S.estimate_tuning_power(S.stft_mag_sq(x.double()), 22050, 2048)
    assert torch.equal(idx, idx64)
    for a, b in ((0, 40), (40, 52), (52, 180)):
        assert np.abs(got[:, a:b] - want[:, a:b]).max() <= 2e-4 * np.abs(want[:, a:b]).max()


def test_resnet_forward_on_the_card(cuda, no_tf32):
    """ResNetAttn's float32 eval forward at 224 x 224, batch 2, card against
    CPU to 1e-4 of the logits' scale."""
    from eav_tpu_torch.models.resnet_attn import ResNetAttn

    x = torch.randn(2, 224, 224, 3, generator=torch.Generator().manual_seed(0))
    model = ResNetAttn(generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        want = model(x)
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path, monkeypatch):
    """A seeded AST written under HF names (safetensors) and imported through
    ``EAV_TPU_AST_CKPT`` gives the source's backbone features on the card."""
    from eav_tpu_torch.models import hf_import as H
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.train.pipeline import _pretrained_params

    src = ast_tiny(generator=torch.Generator().manual_seed(4)).to(cuda).eval()
    H.write_safetensors(str(tmp_path / "model.safetensors"),
                        H.to_hf_state_dict({k: v.cpu() for k, v in src.state_dict().items()},
                                           "ast"))
    monkeypatch.setenv("EAV_TPU_AST_CKPT", str(tmp_path))
    model = ast_tiny()
    model.load_state_dict(_pretrained_params("ast", 5))
    x = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(5)).to(cuda)
    with torch.no_grad():
        torch.testing.assert_close(model.to(cuda).eval()(x, mode="features"),
                                   src(x, mode="features"), atol=1e-6, rtol=1e-6)
