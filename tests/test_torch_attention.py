"""The port's flash attention (plain versions, the CPU side of the CUDA
kernels, and the autograd function) against the JAX package's Pallas kernels
run in interpret mode, on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eav_tpu.ops.pallas import attention as J
from eav_tpu_torch.ops import attention as A


def _qkv(rng, shape, n=3):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("t", [197, 300])
def test_forward_matches_pallas(rng, t):
    b, h, d = 2, 2, 16
    q, k, v = _qkv(rng, (b, t, h, d))
    o_j, lse_j = J._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    o = A.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    bh = [A._to_bh(torch.from_numpy(x)) for x in (q, k, v)]
    _, lse = A.flash_fwd_plain(*bh, t)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :t, 0], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("t", [197, 300])
def test_gradients_match_pallas(rng, t):
    b, h, d = 1, 2, 16
    q, k, v, g = _qkv(rng, (b, t, h, d), 4)

    def loss_j(q, k, v):
        return (J.flash_attention(q, k, v, True) * jnp.asarray(g)).sum()

    want = jax.grad(loss_j, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    got = torch.autograd.grad(A.flash_attention(*leaves), leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)


def test_bf16_forward_and_gradients_match_pallas(rng):
    b, t, h, d = 2, 300, 2, 32
    q, k, v, g = (x.astype(jnp.bfloat16) for x in _qkv(rng, (b, t, h, d), 4))

    def loss_j(q, k, v):
        return (J.flash_attention(q, k, v, True).astype(jnp.float32)
                * jnp.asarray(g, jnp.float32)).sum()

    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    o_j = J.flash_attention(qj, kj, vj, True)
    want = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    to_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    leaves = [to_t(x).requires_grad_(True) for x in (q, k, v)]
    o = A.flash_attention(*leaves)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().detach().numpy(), np.asarray(o_j, np.float32),
                               rtol=0.08, atol=0.08)
    got = torch.autograd.grad(o, leaves, to_t(g))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   rtol=0.08, atol=0.08)


def test_bh_layout_with_t_real_matches_pallas(rng):
    """Head-major operands padded to the JAX kernel's length, keys past
    ``t_real`` masked: values and gradients equal the JAX head-major kernel."""
    b, t, h, d = 2, 200, 2, 16
    _, _, t_pad = J._pick_blocks(t)
    q, k, v, g = _qkv(rng, (b * h, t_pad, d), 4)
    for x in (q, k, v):
        x[:, t:] = 0.0  # padded rows as the (B, T, H, D) adapters make them
    g[:, t:] = 0.0

    def loss_j(q, k, v):
        return (J.flash_attention_bh(q, k, v, t, True) * jnp.asarray(g)).sum()

    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    o_j = J.flash_attention_bh(qj, kj, vj, t, True)
    want = jax.grad(loss_j, argnums=(0, 1, 2))(qj, kj, vj)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = A.flash_attention_bh(*leaves, t)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
    # padded keys get exactly zero gradient
    assert not got[1][:, t:].any() and not got[2][:, t:].any()


def test_plain_versions_do_not_count_launches(rng):
    """On CPU tensors the wrappers run the plain versions; the launch counts
    are for CUDA kernel launches only."""
    A.reset_launches()
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(rng, (2, 70, 16), 4))
    o, lse = A.flash_fwd(q, k, v, 70)
    di = (do * o).sum(-1)
    A.flash_dkv(q, k, v, do, lse, di, 70)
    A.flash_dq(q, k, v, do, lse, di, 70)
    A.flash_onepass(q, k, v, 70)
    assert [fn.launches for fn in A.KERNELS] == [0, 0, 0, 0]


def test_a_capture_tallies_its_launches_until_each_replay():
    """Launches on a stream under ``tally_launches`` (a graph's capture) go
    to the tally, not to ``.launches``; launches on other streams count as
    before; each ``add_launches`` (a replay) counts the tally once more."""
    from types import SimpleNamespace

    A.reset_launches()
    capturing, other = SimpleNamespace(cuda_stream=11), 12
    with A.tally_launches(capturing) as tally:
        for fn in (A.flash_fwd, A.flash_fwd, A.flash_dkv, A.flash_dq):
            A._count(fn, capturing.cuda_stream)
        A._count(A.flash_fwd, other)
    assert tally == {A.flash_fwd: 2, A.flash_dkv: 1, A.flash_dq: 1}
    assert [fn.launches for fn in A.KERNELS] == [1, 0, 0, 0]
    A._count(A.flash_fwd, capturing.cuda_stream)  # the capture has ended
    for _ in range(3):
        A.add_launches(tally)
    assert [fn.launches for fn in A.KERNELS] == [2 + 3 * 2, 3, 3, 0]
    A.reset_launches()


def test_wrappers_refuse_other_devices_and_bad_operands():
    meta = torch.empty(2, 64, 16, device="meta")
    with pytest.raises(ValueError, match="CPU or one CUDA device"):
        A.flash_fwd(meta, meta, meta, 64)
    x = torch.zeros(2, 64, 24)
    with pytest.raises(ValueError, match="head dim"):
        A.flash_fwd(x, x, x, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_fwd(*(torch.zeros(2, 64, 16, dtype=torch.float16),) * 3, 64)


def test_resource_usage_reads_the_ptxas_report(tmp_path, monkeypatch):
    """The build keeps ptxas's report beside the library; resource_usage
    reads each kernel's registers and spill bytes from it, by name and D."""
    from eav_tpu_torch.ops import build

    entry = ("ptxas info    : Compiling entry function "
             "'_ZN51_GLOBAL__N__2512834a_18_flash_attention_cu_a54ae1a3{n}{name}ILi{d}EEEvPK' for 'sm_90a'\n"
             "ptxas info    : Function properties for _ZN...\n"
             "    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
             "ptxas info    : Used {regs} registers, used 1 barriers\n")
    (tmp_path / "libx.log").write_text(
        entry.format(n=15, name="flash_dkv_wgmma", d=64, spill=0, regs=165)
        + entry.format(n=15, name="flash_fwd_wgmma", d=128, spill=28, regs=168))
    monkeypatch.setattr(build, "build", lambda name: tmp_path / "libx.so")
    assert build.resource_usage("x") == {"flash_dkv_wgmma<64>": (165, 0),
                                         "flash_fwd_wgmma<128>": (168, 28)}


def test_flash_variants_patch_the_committed_source():
    """Each A/B variant of the timing script patches the CUDA source where
    its text occurs exactly once, so the script measures what it names."""
    from eav_tpu_torch.ops import build
    from eav_tpu_torch.scripts import flash_variants as V

    src = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for name in V.VARIANTS:
        assert (V.patched(name) == src) == (name == "committed"), name


# -----------------------------------------------------------------------------
# Under torch.func.vmap: the stack folded into B·H (a stacked fit's path)
# -----------------------------------------------------------------------------


class _Attention(torch.nn.Module):
    """Attention of a (B, T, 3, H, D) q/k/v stack, as ``transformer.Remat``
    recomputes a sublayer (``block`` names it)."""

    def forward(self, x, block=None):
        return A.flash_attention(*x.unbind(2))


def _vmapped_loss_and_grads(q, k, v, remat: str):
    """The port: vmap over the stack of grad_and_value of sum(attention²),
    the attention rematted through ``transformer.Remat`` with 'attn'."""
    from torch.func import grad_and_value, vmap

    from eav_tpu_torch.models.transformer import Remat

    module = _Attention()

    def loss(q, k, v):
        if remat == "attn":
            o = Remat.apply(module, "attn", (), torch.stack((q, k, v), 2))
        else:
            o = A.flash_attention(q, k, v)
        return (o ** 2).sum()

    grads, value = vmap(grad_and_value(loss, argnums=(0, 1, 2)))(
        *(torch.from_numpy(x) for x in (q, k, v)))
    return value.numpy(), [g.numpy() for g in grads]


def _jax_vmapped(q, k, v, remat: str):
    def loss(q, k, v):
        attn = lambda q, k, v: J.flash_attention(q, k, v, True)  # noqa: E731
        if remat == "attn":
            attn = jax.checkpoint(attn)
        return (attn(q, k, v) ** 2).sum()

    value, grads = jax.vmap(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_vmapped_flash_matches_jax_vmapped_pallas(rng, remat):
    """The stack axis folded into B·H (one call for the stack) against the
    Pallas kernels under ``jax.vmap`` (the stack lifted into the grid), at
    tests/test_pallas_attention.py's vmap shape and tolerances; with remat,
    the backward runs the recompute under vmap too."""
    s, b, t, h, d = 3, 2, 96, 2, 32
    q, k, v = _qkv(rng, (s, b, t, h, d))
    value, grads = _vmapped_loss_and_grads(q, k, v, remat)
    want_value, want_grads = _jax_vmapped(q, k, v, remat)
    np.testing.assert_allclose(value, want_value, rtol=2e-5)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=5e-4, atol=5e-5)


def test_one_plain_call_serves_the_stack(rng, monkeypatch):
    """Each of K1-K3's plain versions runs once for the whole stack, on
    (S·B·H, T, D) operands, with remat's recompute once more for K1."""
    s, b, t, h, d = 3, 2, 40, 2, 16
    shapes = {n: [] for n in ("flash_fwd_plain", "flash_dkv_plain", "flash_dq_plain")}
    for name in shapes:
        plain = getattr(A, name)
        monkeypatch.setattr(A, name, lambda *a, _p=plain, _n=name: (
            shapes[_n].append(tuple(a[0].shape)), _p(*a))[1])
    _vmapped_loss_and_grads(*_qkv(rng, (s, b, t, h, d)), "attn")
    folded = (s * b * h, t, d)
    assert shapes == {"flash_fwd_plain": [folded, folded], "flash_dkv_plain": [folded],
                      "flash_dq_plain": [folded]}


def test_a_subject_interleaving_fold_fails(rng, monkeypatch):
    """A planted fault: the stack folded B·H-major ((BH, S) order) while the
    outputs are read back subject-major hands each subject another's rows;
    the comparison against JAX must catch it."""
    s, b, t, h, d = 3, 2, 96, 2, 32
    q, k, v = _qkv(rng, (s, b, t, h, d))

    def interleaved(x, dim, size):
        x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
        return x.transpose(0, 1).reshape(size * x.shape[1], *x.shape[2:]).contiguous()

    monkeypatch.setattr(A, "_fold", interleaved)
    value, grads = _vmapped_loss_and_grads(q, k, v, "none")
    want_value, want_grads = _jax_vmapped(q, k, v, "none")
    assert not np.allclose(value, want_value, rtol=2e-5)
    assert not any(np.allclose(g, w, rtol=5e-4, atol=5e-5) for g, w in zip(grads, want_grads))


def test_a_folded_bh_past_the_grid_limit_raises():
    """B·H lies on blockIdx.y, capped at 65,535 blocks: a stack that folds
    past it raises in the wrapper, before any kernel or plain version runs;
    65,535 itself is taken."""
    from torch.func import vmap

    x = torch.zeros(2, 1, 1, 32768, 16)  # S 2 of (B 1, T 1, H 32768, D 16)
    with pytest.raises(ValueError, match="grid limit of 65535"):
        vmap(A.flash_attention)(x, x, x)
    one = torch.zeros(A.MAX_BH, 1, 16)
    assert A.flash_fwd(one, one, one, 1)[0].shape == one.shape
