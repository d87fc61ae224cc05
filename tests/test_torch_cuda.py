"""The CUDA flash-attention kernels (K1-K3 and the one-pass K5) against their
plain versions on the card, a fit that repeats bit for bit on the card under
the trainer's deterministic mode, and the fifth slice on the card: the
scnn180 chain against float64 on the CPU, ResNetAttn's forward against the
CPU, an HF checkpoint round trip, the kernels under ``torch.func.vmap``
(one launch for a stack), and the trainer's steps replayed as CUDA graphs
against the same steps run eagerly.

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


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_vmapped_kernels_match_plain_with_one_launch_a_stack(cuda, remat):
    """vmap(grad_and_value) of float32 attention over a stack of 3 on the
    card against the same on the CPU (the plain versions): values and
    gradients agree, and K1, K2, K3 each launch once for the whole stack
    (K1 once more for remat's recompute)."""
    from torch.func import grad_and_value, vmap

    from eav_tpu_torch.models.transformer import Remat

    class Attention(torch.nn.Module):
        def forward(self, x, block=None):
            return A.flash_attention(*x.unbind(2))

    module = Attention()

    def loss(q, k, v):
        if remat == "attn":
            return (Remat.apply(module, "attn", (), torch.stack((q, k, v), 2)) ** 2).sum()
        return (A.flash_attention(q, k, v) ** 2).sum()

    gen = torch.Generator().manual_seed(5)
    qkv = [torch.randn(3, 2, 96, 2, 32, generator=gen) for _ in range(3)]
    run = vmap(grad_and_value(loss, argnums=(0, 1, 2)))
    want_grads, want = run(*qkv)
    A.reset_launches()
    grads, value = run(*(x.to(cuda) for x in qkv))
    torch.cuda.synchronize()
    assert [fn.launches for fn in A.KERNELS] == [2 if remat == "attn" else 1, 1, 1, 0]
    torch.testing.assert_close(value.cpu(), want, rtol=2e-4, atol=2e-4)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)


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


# ---------------------------------------------------------------------------
# Trainer.train_step as a replayed CUDA graph, against the same steps run
# eagerly: a registered forward hook keeps a trainer's steps eager.
# ---------------------------------------------------------------------------


def _graph_trainer(cuda, eager, dropout=0.0, deterministic=False):
    """A tiny AST with flash attention in a Trainer, its weights and dropout
    generator seeded; with ``eager``, a no-op forward hook keeps its steps
    eager."""
    from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
    from eav_tpu_torch.models.ast import ast_tiny
    from eav_tpu_torch.models.dropout import set_generator
    from eav_tpu_torch.train.loop import Trainer

    cfg = FinetuneConfig(model="ast", batch_size=8, weight_decay=0.01,
                         phases=(PhaseConfig(1, 1e-3, True), PhaseConfig(3, 1e-4, False)))
    model = ast_tiny(dropout=dropout, attn_impl="flash")
    model.reset_parameters(torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, device=cuda, deterministic=deterministic)
    set_generator(trainer.model, torch.Generator(device=cuda).manual_seed(7))
    if eager:
        trainer.model.register_forward_hook(lambda *args: None)
    return trainer


def _graph_data(cuda, n=20):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(n, 128, 128, generator=gen, device=cuda)
    return x, torch.randint(0, 5, (n,), generator=gen, device=cuda)


def _run_schedule(cuda, eager, schedule, dropout=0.0, deterministic=False):
    """``schedule``: (rows, lr, freeze) a step, through ``train_step`` ->
    (losses as returned, parameters after, the trainer, K1-K3 launches)."""
    from eav_tpu_torch.core.device import deterministic_algorithms
    from eav_tpu_torch.core.optim import make_optimizer, set_trainable

    trainer = _graph_trainer(cuda, eager, dropout)
    x, y = _graph_data(cuda)
    opt = make_optimizer(trainer.model, trainer.cfg)
    assert not any(g["capturable"] for g in opt.param_groups)
    trainer.model.train()
    A.reset_launches()
    losses = []
    with deterministic_algorithms(deterministic):
        for rows, lr, freeze in schedule:
            set_trainable(trainer.model, freeze)
            for group in opt.param_groups:
                group["lr"] = lr
            losses.append(trainer.train_step(opt, x[rows], y[rows])[0])
        torch.cuda.synchronize()
    # the trainer's first step made it capturable, an eager trainer's too
    assert all(g["capturable"] for g in opt.param_groups)
    launches = [fn.launches for fn in A.KERNELS[:3]]
    return losses, {n: p.detach().clone() for n, p in trainer.model.named_parameters()}, \
        trainer, launches


def _assert_same(got, want, bitwise):
    if bitwise:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **_tol(torch.float32, 0))


@pytest.mark.parametrize("deterministic", [True, False])
def test_graphed_steps_match_eager_steps(cuda, deterministic):
    """Six steps of one shape: the first eager on the side stream, the
    second captured and replayed, four replayed; losses and parameters
    equal the eager trainer's (bit for bit in the deterministic mode). The
    losses returned are tensors of their own, and the K1-K3 counters count
    every replay's launches."""
    schedule = [(slice(2 * i, 2 * i + 8), 1e-3, False) for i in range(6)]
    want, want_p, _, want_n = _run_schedule(cuda, True, schedule, deterministic=deterministic)
    got, got_p, trainer, got_n = _run_schedule(cuda, False, schedule,
                                               deterministic=deterministic)
    assert trainer.step_counts == {"eager": 1, "captured": 1, "replayed": 4}
    assert len({loss.data_ptr() for loss in got}) == len(got)
    _assert_same(torch.stack(got), torch.stack(want), deterministic)
    for name in want_p:
        _assert_same(got_p[name], want_p[name], deterministic)
    assert got_n == want_n and got_n[0] == 6 * 2  # a launch of K1 per layer a step


def test_lr_and_trainable_changes_recapture(cuda):
    """A new lr and a new trainable set are new steps: each runs eagerly,
    then is captured; going back to an earlier lr and set replays its graph
    (the three share one memory pool); the parameters follow the eager
    trainer's."""
    rows = [slice(0, 8), slice(4, 12), slice(8, 16)]
    schedule = ([(r, 1e-3, False) for r in rows] + [(r, 3e-4, False) for r in rows]
                + [(r, 3e-4, True) for r in rows] + [(rows[0], 1e-3, False), (rows[1], 3e-4, True)])
    want, want_p, _, _ = _run_schedule(cuda, True, schedule, deterministic=True)
    got, got_p, trainer, _ = _run_schedule(cuda, False, schedule, deterministic=True)
    assert trainer.step_counts == {"eager": 3, "captured": 3, "replayed": 5}
    assert len(trainer._graphs) == 3
    assert torch.equal(torch.stack(got), torch.stack(want))
    for name in want_p:
        assert torch.equal(got_p[name], want_p[name]), name


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_graphed_fit_matches_eager_fit(cuda, dropout):
    """A fit of 20 rows at batch 8 (the last batch 4, a graph of its own),
    one frozen and three unfrozen epochs, dropout from the fit's generator:
    history and test logits equal the eager fit's, bit for bit in the
    deterministic mode, with the graphs of 8 and of 4 sharing one memory
    pool and replaying in turns; the fit drops its graphs at the end."""
    x, y = _graph_data(cuda, 26)
    data = (x[:20].cpu(), y[:20].cpu(), x[20:].cpu(), y[20:].cpu())
    results = []
    for eager in (True, False):
        trainer = _graph_trainer(cuda, eager, dropout, deterministic=True)
        results.append((trainer.fit(data, seed=3), trainer))
    (want, _), (got, trainer) = results
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_array_equal(got.history[k], want.history[k], err_msg=k)
    np.testing.assert_array_equal(got.outputs_test, want.outputs_test)
    # steps of 8, 8, 4: the frozen epoch runs the 8 eagerly, captures it,
    # runs the 4 eagerly; the first unfrozen epoch the same (a new lr and
    # trainable set); the second replays the 8 twice and captures the 4;
    # the third replays all three
    assert trainer.step_counts == {"eager": 4, "captured": 3, "replayed": 5}
    assert not trainer._graphs


def test_graphed_vit_fit_resizes_uint8_frames(cuda):
    """ViT on uint8 48 x 48 frames, resized to 64 on the card inside the
    forward (the vision preset's path): its weights are made on the card in
    the eager first step, so the capture copies nothing from the host; the
    fit equals the eager fit bit for bit in the deterministic mode."""
    from eav_tpu_torch.core.config import FinetuneConfig, PhaseConfig
    from eav_tpu_torch.models.vit import vit_tiny
    from eav_tpu_torch.train.loop import Trainer

    gen = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (26, 48, 48, 3), generator=gen, dtype=torch.uint8)
    labels = torch.randint(0, 5, (26,), generator=gen)
    data = (frames[:20], labels[:20], frames[20:], labels[20:])
    cfg = FinetuneConfig(model="vit", batch_size=8, weight_decay=0.01,
                         phases=(PhaseConfig(3, 1e-3, False),))
    results = []
    for eager in (True, False):
        model = vit_tiny(preprocess_uint8=True)
        model.reset_parameters(torch.Generator().manual_seed(0))
        trainer = Trainer(model, cfg, device=cuda, deterministic=True)
        if eager:
            trainer.model.register_forward_hook(lambda *args: None)
        results.append((trainer.fit(data, seed=3), trainer.step_counts))
    (want, _), (got, counts) = results
    assert counts == {"eager": 2, "captured": 2, "replayed": 5}
    for k in ("loss", "train_acc", "test_acc"):
        np.testing.assert_array_equal(got.history[k], want.history[k], err_msg=k)
    np.testing.assert_array_equal(got.outputs_test, want.outputs_test)


def test_hooks_and_debug_nans_keep_steps_eager(cuda):
    """A forward hook on a module, and ``debug_nans`` (a global forward hook
    and anomaly mode), keep every step eager."""
    from eav_tpu_torch.core.optim import make_optimizer
    from eav_tpu_torch.utils.profiling import debug_nans

    x, y = _graph_data(cuda)
    for hooked in (True, False):
        trainer = _graph_trainer(cuda, eager=hooked)
        opt = make_optimizer(trainer.model, trainer.cfg)
        with debug_nans(not hooked):
            for _ in range(3):
                trainer.train_step(opt, x[:8], y[:8])
        assert trainer.step_counts == {"eager": 3, "captured": 0, "replayed": 0}
        assert not trainer._graphs


def test_fits_on_two_threads(cuda):
    """The farm's pattern: two trainers fit on one card from two threads at
    once, capturing and replaying; each result equals that trainer's fit
    alone."""
    import threading

    x, y = _graph_data(cuda, 26)
    data = (x[:20].cpu(), y[:20].cpu(), x[20:].cpu(), y[20:].cpu())
    alone = [_graph_trainer(cuda, False).fit(data, seed=s) for s in (3, 4)]
    trainers = [_graph_trainer(cuda, False) for _ in range(2)]
    results, errors = [None, None], []

    def fit(i):
        try:
            results[i] = trainers[i].fit(data, seed=3 + i)
        except Exception as e:  # noqa: BLE001 - reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=fit, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for got, want, trainer in zip(results, alone, trainers):
        assert trainer.step_counts == {"eager": 4, "captured": 3, "replayed": 5}
        np.testing.assert_allclose(got.outputs_test, want.outputs_test, rtol=2e-4, atol=2e-4)
