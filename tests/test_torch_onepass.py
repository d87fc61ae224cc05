"""The port's one-pass forward (K5's plain version and its (B, T, H, D) API)
against the experiment script's own Pallas kernel in interpret mode, and
against the einsum reference, on the same numpy inputs.

``scripts/flash_onepass_experiment.py`` asserts a TPU and does its work at
import, so it is not imported: its ``_onepass_kernel`` and ``onepass_forward``
definitions are taken from its syntax tree and run in a namespace where
``pl.pallas_call`` runs in interpret mode. Tolerances are the JAX attention
tests': float32 2e-5, bfloat16 0.08.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eav_tpu.ops.pallas import attention as J
from eav_tpu_torch.ops import attention as A

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "flash_onepass_experiment.py")


def _script(pallas_call=functools.partial(pl.pallas_call, interpret=True)):
    """The script's ``onepass_forward`` with its ``_onepass_kernel``, bound
    to ``pallas_call`` (interpret mode by default)."""
    with open(SCRIPT) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in ("_onepass_kernel", "onepass_forward")]
    assert len(keep) == 2
    shim = types.SimpleNamespace(pallas_call=pallas_call, BlockSpec=pl.BlockSpec)
    ns = dict(jax=jax, jnp=jnp, np=np, pl=shim, functools=functools, NEG_INF=J.NEG_INF,
              _pick_blocks=J._pick_blocks, _to_bh=J._to_bh, _from_bh=J._from_bh)
    exec(compile(ast.Module(body=keep, type_ignores=[]), SCRIPT, "exec"), ns)
    return ns["onepass_forward"]


def _inputs(rng, t, dtype):
    b, h, d = 1, 2, 16  # B*H <= 4
    xs = [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]
    if dtype == "bfloat16":
        xs = [np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in xs]
    return xs


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


TOL = {"float32": 2e-5, "bfloat16": 0.08}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [197, 300, 1214])
def test_matches_the_scripts_kernel(rng, t, dtype):
    xs = _inputs(rng, t, dtype)
    want = np.asarray(_script()(*(jnp.asarray(x, dtype) for x in xs)).astype(jnp.float32))
    got = A.flash_onepass_attention(*_torch(xs, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [197, 300, 1214])
def test_matches_the_reference_attention(rng, t, dtype):
    xs = _inputs(rng, t, dtype)
    want = np.asarray(J._reference_attention(*(jnp.asarray(x, jnp.float32) for x in xs)))
    got = A.flash_onepass_attention(*_torch(xs, dtype))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_plain_on_padded_rows_matches_the_scripts_lse(rng):
    """Head-major operands padded to the script's length, keys past t_real
    replaced by -1e30: the plain version's LSE equals the Pallas kernel's on
    every row, padded ones included."""
    t = 300
    xs = _inputs(rng, t, "float32")
    _, _, t_pad = J._pick_blocks(t)
    qb, kb, vb = (np.array(J._to_bh(jnp.asarray(x), 1, 2, 16, t_pad)) for x in xs)
    captured = {}

    def spy(*args, **kw):  # keeps the kernel's head-major (o, lse)
        fn = pl.pallas_call(*args, **kw, interpret=True)

        def run(*ops):
            captured["out"] = fn(*ops)
            return captured["out"]
        return run

    _script(spy)(*(jnp.asarray(x) for x in xs))
    o_j, lse_j = (np.asarray(a) for a in captured["out"])
    o, lse = A.flash_onepass_plain(*(torch.from_numpy(x) for x in (qb, kb, vb)), t)
    np.testing.assert_allclose(o.numpy(), o_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_j[..., 0], rtol=2e-5, atol=2e-5)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(rng):
    A.reset_launches()
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 90, 32)).astype(np.float32))
               for _ in range(3))
    o, lse = A.flash_onepass(q, k, v, 80)
    o_p, lse_p = A.flash_onepass_plain(q, k, v, 80)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert A.flash_onepass.launches == 0
    # K5 and K1 compute the same function: the plain versions agree
    o1, lse1 = A.flash_fwd_plain(q, k, v, 80)
    torch.testing.assert_close(o, o1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(lse, lse1, rtol=1e-6, atol=1e-6)


def test_stripe_limit():
    """The float32 kernel's stripe of 32 rows of float32 scores bounds its T
    on the card: T 1214 fits at head dim 64; the limit is where one more
    64-key tile would pass a block's shared memory."""
    t_max = A.onepass_max_len(64)
    assert t_max >= 1214
    assert A.onepass_smem_bytes(64, t_max) <= A.SMEM_LIMIT
    assert A.onepass_smem_bytes(64, t_max + 1) > A.SMEM_LIMIT
    assert A.onepass_smem_bytes(64, 1214) == 4 * (32 * 1232 + 32 + (32 + 64) * 65)


def test_bf16_past_the_stripe_limit_runs_the_plain_version_on_cpu(rng):
    """The bf16 kernel keeps no stripe, so no length bound applies to it: CPU
    bf16 tensors past the float32 limit (T 2048, 2000 real keys) run the
    plain version and count no launch."""
    assert A.onepass_max_len(64) < 2000
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2048, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    A.reset_launches()
    o, lse = A.flash_onepass(q, k, v, 2000)
    o_p, lse_p = A.flash_onepass_plain(q, k, v, 2000)
    assert o.dtype == torch.bfloat16 and o.shape == (1, 2048, 64) and lse.shape == (1, 2048)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    assert A.flash_onepass.launches == 0


def test_experiment_runs_on_cpu():
    """The experiment's entry point at a small shape on the CPU, where both
    forwards run their plain versions (the same arithmetic, so they agree
    exactly): every reading is present."""
    from eav_tpu_torch.scripts.flash_onepass_experiment import run

    res = run(device="cpu", b=1, t=197, h=2, d=64, mlp=64, steps=1)
    assert res["device"] == "cpu" and res["shape"] == [1, 197, 2, 64]
    assert res["max_abs_err"] == 0.0
    for key in ("stream_ms", "onepass_ms", "gelu_erf_ms", "gelu_tanh_ms"):
        assert res[key] > 0
