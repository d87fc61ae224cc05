"""The port's multi-card layer on the CPU: the multi-host seam
(``parallel/distributed.py``), the mesh (``parallel/mesh.py``), data
parallelism (``Trainer.fit(mesh=)``), tensor parallelism
(``parallel/tp.py``) and the subject axis (``SubjectParallelTrainer(mesh=)``),
each at two gloo ranks spawned on 127.0.0.1 (``tests/torch_ranks.py``), as
``tests/test_distributed.py`` runs JAX's seam.

Criteria: a 2-rank DP fit equals the one-process fit to rtol = atol = 2e-4
(the JAX package's DP bound, ``tests/test_parallel.py:77``), on EEGNet with
BatchNorm, dropout 0.25 and 29 rows at batch 8 (the last batch splits 3 /
2) and on a ViT over uint8 frames through the frozen-feature cache; two
planted faults (the mean of local means, BatchNorm on local statistics)
must fail that check. TP: loss to rtol 1e-5 and every gradient to 1e-4 of
the largest gradient entry (``tests/test_parallel.py:340-351``) against the
unsharded step; a contiguous cut of qkv's rows must fail."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks as R
from eav_tpu_torch.parallel import distributed, mesh as M, tp
from eav_tpu_torch.parallel.subject import SubjectParallelTrainer
from eav_tpu_torch.train.loop import Trainer

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dp():
    return distributed.spawn(R.dp_fits, 2, ("local_mean", "local_bn"), device="cpu")


@pytest.fixture(scope="module")
def tp_runs():
    return distributed.spawn(R.tp_cases, 2, device="cpu")


@pytest.fixture(scope="module")
def seam():
    return distributed.spawn(R.seam, 2, device="cpu")


def test_init_multihost_without_coordinator_is_a_noop(monkeypatch):
    monkeypatch.delenv("EAV_TPU_COORDINATOR", raising=False)
    assert distributed.init_multihost() is False
    assert distributed.init_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_global_mesh_axes_equal_jax():
    from eav_tpu.parallel.distributed import global_mesh_axes

    assert distributed.global_mesh_axes() == global_mesh_axes()


def test_one_rank_group_from_the_variable_and_the_mesh_rules(monkeypatch):
    """``EAV_TPU_COORDINATOR`` forms the group (world 1, in this process);
    ``make_mesh`` keeps JAX's -1 rule and both of its errors."""
    from eav_tpu.parallel.mesh import make_mesh as jax_make_mesh

    monkeypatch.setenv("EAV_TPU_COORDINATOR", f"127.0.0.1:{distributed.free_port()}")
    assert distributed.init_multihost(num_processes=1, process_id=0, device="cpu") is True
    try:
        mesh = M.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == (M.DATA_AXIS,) and M.axis_size(mesh, M.DATA_AXIS) == 1
        two = M.make_mesh(((M.DATA_AXIS, -1), (M.MODEL_AXIS, 1)), "cpu")
        assert (M.axis_size(two, M.MODEL_AXIS), M.axis_index(two, M.DATA_AXIS)) == (1, 0)
        assert M.axis_group(None, M.DATA_AXIS) is None and M.axis_size(mesh, M.MODEL_AXIS) == 1
        for axes, msg in ((((M.DATA_AXIS, -1), (M.MODEL_AXIS, -1)), "at most one"),
                          (((M.DATA_AXIS, 2),), "mesh of 2 devices > 1 available")):
            with pytest.raises(ValueError, match=msg):
                M.make_mesh(axes, "cpu")
            with pytest.raises(ValueError, match=msg):  # the JAX package's words
                jax_make_mesh(axes, devices=__import__("jax").devices()[:1])
        t = torch.ones(2)
        dist.all_reduce(t)
        assert t.tolist() == [1.0, 1.0]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("n,parts", [(5, 2), (29, 4), (2, 3), (8, 8)])
def test_share_is_tensor_splits_cut(n, parts):
    x = torch.arange(n)
    for i, want in enumerate(torch.tensor_split(x, parts)):
        lo, hi = M.share(n, parts, i)
        assert x[lo:hi].tolist() == want.tolist()


def test_two_rank_seam(seam):
    """``init_multihost``'s group sums over both ranks; ``agreed`` fails a
    call on both ranks when it failed on one; a mesh of one rank in a group
    of two is refused."""
    assert [s["all_reduce"] for s in seam] == [(3.0, 2), (3.0, 2)]
    smaller = "mesh of 1 devices < the group's 2 ranks: a mesh holds every rank"
    assert seam[0]["agreed"] == [0, "RuntimeError: failed on another rank: rank 1: "
                                    "ValueError: rank 1 fails", smaller]
    assert seam[1]["agreed"] == [1, "ValueError: rank 1 fails", smaller]


def test_subject_axis_equals_one_process_stack(seam):
    """5 subjects over 2 ranks (3 and 2) with a partial init overlay: the
    first rank gathers the one-process stack's result; the other gets None."""
    data, seeds, init = R.stack_data()
    want = SubjectParallelTrainer(R.eeg_model(), R.EEG_CFG, device="cpu").fit_stacked(
        data, seeds=seeds, init_params=init)
    got = seam[0]["stacked"]
    assert seam[1]["stacked"] is None
    np.testing.assert_allclose(got["logits"], want.outputs_test, **TOL)
    for k, v in want.history.items():
        np.testing.assert_allclose(got["history"][k], v, **TOL)
    assert got["params"].keys() == want.params.keys()
    for k, v in want.params.items():
        np.testing.assert_allclose(got["params"][k], v.numpy(), **TOL, err_msg=k)
    np.testing.assert_allclose(got["params"]["head.bias"][:, 0], 0.1, atol=0.05)


@pytest.mark.parametrize("model", ["eeg", "vit"])
def test_dp_fit_equals_one_process_fit(dp, model):
    make, data, cfg, seed = ((R.eeg_model, R.eeg_data(), R.EEG_CFG, 3) if model == "eeg"
                             else (R.vit_model, R.vit_data(), R.VIT_CFG, 4))
    want = Trainer(make(), cfg, device="cpu").fit(data, seed=seed)
    np.testing.assert_array_equal(dp[0][model]["logits"], dp[1][model]["logits"])
    for k in dp[0][model]["params"]:  # the ranks' weights stay equal
        np.testing.assert_array_equal(dp[0][model]["params"][k], dp[1][model]["params"][k])
    got = dp[0][model]
    np.testing.assert_allclose(got["logits"], want.outputs_test, **TOL)
    for k, v in want.history.items():
        np.testing.assert_allclose(got["history"][k], v, **TOL, err_msg=k)
    for k, v in want.params.items():  # BatchNorm's running stats included
        if k.endswith("attn.qkv.bias"):
            # the key bias's gradient is exactly zero (softmax drops a
            # per-row constant): Adam turns its roundoff into steps of up
            # to lr, as tests/test_torch_train.py allows (2 lr a step)
            q, key, v_ = np.split(got["params"][k] - v.numpy(), 3)
            np.testing.assert_allclose(np.concatenate([q, v_]), 0, atol=2e-4, err_msg=k)
            assert np.abs(key).max() <= 2 * 1e-3 * 6, k  # lr 1e-3, 6 unfrozen steps
            continue
        np.testing.assert_allclose(got["params"][k], v.numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("fault", ["local_mean", "local_bn"])
def test_dp_planted_faults_fail_the_check(dp, fault):
    want = Trainer(R.eeg_model(), R.EEG_CFG, device="cpu").fit(R.eeg_data(), seed=3)
    assert not np.allclose(dp[0][fault]["logits"], want.outputs_test, **TOL)


def _tp_error(runs, ref, contiguous):
    """Max over ranks and leaves of |rank's gradient - its shard of the
    unsharded one| / the unsharded gradient's largest entry."""
    scale = max(float(g.abs().max()) for g in ref.values())
    worst = 0.0
    for rank, (_, grads) in enumerate(runs):
        for k, g in grads.items():
            spec = tp.tp_spec(k)
            if contiguous and spec is not None and "qkv" in k:
                spec = (0, 1)
            want = ref[k] if spec is None else tp.shard_tensor(ref[k], spec, rank, 2)
            assert g.shape == tuple(want.shape), k
            worst = max(worst, float(np.abs(g - want.numpy()).max()) / scale)
    return worst


@pytest.mark.parametrize("case", R.TP_CASES, ids=["no_remat", "remat_full", "contiguous_qkv"])
def test_tp_step_equals_unsharded(tp_runs, case):
    """Dropout 0.1 on both sides (the same masks on every model rank);
    with remat 'full' the collectives run again in the recompute."""
    from eav_tpu_torch.models.ast import ast_tiny

    remat, contiguous = case
    ref_loss, ref = R.tp_step(ast_tiny(**R.TP_MODEL, dropout=0.1, remat=remat), *R.tp_batch())
    runs = [r[case] for r in tp_runs]
    err = _tp_error(runs, ref, contiguous)
    if contiguous:  # a contiguous cut gives rank 0 all of q: wrong math
        assert err > 1e-2 and not np.isclose(runs[0][0], ref_loss, rtol=1e-5)
        return
    for loss, _ in runs:
        assert np.isclose(loss, ref_loss, rtol=1e-5)
    assert err < 1e-4, err


def test_tp_rules_are_jax_rules():
    """Each rank's shards under the port's rules equal JAX's shardings of
    the same weights (``eav_tpu/parallel/tp.py``: the last or first dim of
    a Flax kernel cut into contiguous parts), carried across by the
    bridge."""
    import jax
    from jax.sharding import PartitionSpec as P

    from eav_tpu.core.optim import path_str
    from eav_tpu.models.ast import ast_tiny as jax_ast_tiny
    from eav_tpu.parallel.mesh import MODEL_AXIS
    from eav_tpu.parallel.tp import tp_spec as jax_tp_spec
    from eav_tpu_torch.models.bridge import ast_params_from_jax

    model = jax_ast_tiny(**R.TP_MODEL)
    params = model.init(jax.random.PRNGKey(0), np.zeros((1, 128, 128), np.float32),
                        train=False)["params"]
    full = ast_params_from_jax(params)
    split = 0
    for rank in range(2):
        def jax_shard(path, leaf):
            spec = jax_tp_spec(path_str(path))
            leaf = np.asarray(leaf)
            if spec == P():
                return leaf
            dim = list(spec).index(MODEL_AXIS)
            return np.split(leaf, 2, axis=dim)[rank]

        want = ast_params_from_jax(jax.tree_util.tree_map_with_path(jax_shard, params))
        got = {k: tp.shard_tensor(v, spec, rank, 2) if (spec := tp.tp_spec(k)) else v
               for k, v in full.items()}
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
            split += tp.tp_spec(k) is not None
    assert split == 2 * 2 * 6  # 2 ranks x 2 layers x (qkv w, b, out w, fc1 w, b, fc2 w)
    with pytest.raises(ValueError, match="does not split"):
        tp.shard_tensor(torch.zeros(6, 4), (0, 3), 0, 4)
