"""A model family joins the benchmark as files only: a throwaway family, its
configuration, tiny cut, cells, limits and metric added as new files and
entries in a tiny tree run correct, and every fault its mixes declare
turns them incorrect, with no other file of the tree touched. Beside it:
the weights the families draw are the weights drawn before families
existed, their kernel work reads the count the rooflines read before, the
``answer`` fault alters any model a ``Trainer`` holds, and token rows."""

import hashlib
import json
import math
from collections import Counter

import pytest
import torch

from conftest import ROOT, cut

from benchmark import common, faults, yardstick
from benchmark.harness import load_family, load_json, load_module, run_cell
from benchmark.reference import transformer

SEED = 2**31 + 43
CONFIGS = ("ast_base", "vit_base")
MIXES = {"unfrozen": "unfrozen_epochs", "features": "features_pass"}


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def hashes(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def add_family(root):
    """The throwaway family ``ast_copy`` (a copy of ``families/ast.py``) with
    a configuration at AST-base's published widths, its tiny cut, a cell on
    each mix with the limits of AST-base's, and a per-layer metric; added
    as new files and as entries appended to BENCHMARK.json. Returns the new
    cells by mix."""
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (bench / "families/ast_copy.py").write_text((bench / "families/ast.py").read_text())
    cfg = load_json(ROOT / "benchmark/configs/ast_base.json")
    cfg["name"], cfg["model"]["family"] = "ast_copy", "ast_copy"
    (bench / "configs/ast_copy.json").write_text(json.dumps(cfg))
    tiny = bench / "tests" / "tiny"
    (tiny / "ast_copy.json").write_text((tiny / "ast_base.json").read_text())
    spec["configs"].append({"name": "ast_copy", "source": "https://example.org/ast-copy",
                            "file": "benchmark/configs/ast_copy.json", "reduced": [],
                            "why": "a throwaway family"})
    cells = {}
    for short, mix in MIXES.items():
        cells[mix] = f"ast_copy.{short}"
        spec["workloads"].append({"name": cells[mix], "config": "ast_copy", "traffic": mix,
                                  "chips": 1, "why": "throwaway"})
        (bench / f"limits/{cells[mix]}.json").write_text(
            (bench / f"limits/ast_base.{short}.json").read_text())
    moves = {"train_samples_per_s": cells["unfrozen_epochs"],
             "extract_samples_per_s": cells["features_pass"]}
    for e in spec["end_to_end"]:
        if e["name"] in moves:
            e["workloads"].append(moves[e["name"]])
    for m in spec["per_layer"]:
        if m["name"] == "mfu.extract":
            m["workloads"].append(cells["features_pass"])
    spec["per_layer"].append({"name": "units_in_window.train", "unit": "units",
                              "better": "higher", "source": "host_clock", "layer": "harness",
                              "moves": "train_samples_per_s",
                              "workloads": [cells["unfrozen_epochs"]]})
    (bench / "metrics/units_in_window.train.py").write_text(
        "def read(run):\n    return len(run.units)\n")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cut(root, "ast_copy")
    return cells


def only_appended(old, new):
    """Every entry of ``old`` is in ``new`` where it was, changed at most by
    names appended to its ``workloads``."""
    assert set(old) == set(new)
    for key, value in old.items():
        if not isinstance(value, list) or not value or not isinstance(value[0], dict):
            assert new[key] == value, key
            continue
        assert len(new[key]) >= len(value)
        for a, b in zip(value, new[key]):
            w = a.get("workloads")
            assert {k: v for k, v in b.items() if k != "workloads"} == \
                {k: v for k, v in a.items() if k != "workloads"}
            assert (w is None and "workloads" not in b) or b["workloads"][:len(w)] == w


def test_a_new_family_needs_only_files(tiny_root):
    before = hashes(tiny_root)
    old_spec = load_json(tiny_root / "BENCHMARK.json")
    cells = add_family(tiny_root)
    for mix, cell in cells.items():
        for trace_on in (False, True):
            result, info = run_cell(cell, SEED, 0.2, trace_on, "cpu", root=tiny_root)
            assert result["correct"] and result["failed"] == 0, info["readings"]
        if mix == "unfrozen_epochs":
            assert result["metrics"]["units_in_window.train"]["value"] == info["units"]
        driver = load_module(tiny_root / f"benchmark/drivers/{mix}.py", f"family_test_{mix}")
        assert driver.FAULTS
        for fault in driver.FAULTS:
            with faults.plant(fault):
                result, info = run_cell(cell, SEED + 1, 0.2, False, "cpu", root=tiny_root)
            assert result["correct"] is False and result["failed"] >= 1, (fault, info["readings"])
    after = hashes(tiny_root)
    assert {k: v for k, v in after.items() if k in before and k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    only_appended(old_spec, load_json(tiny_root / "BENCHMARK.json"))


def test_a_configuration_without_a_tiny_cut_is_refused(tiny_root):
    (tiny_root / "benchmark/tests/tiny/ast_base.json").unlink()
    with pytest.raises(pytest.fail.Exception, match="no tiny cut"):
        cut(tiny_root, "ast_base")


def test_a_family_without_every_function_is_refused(tiny_root):
    src = (tiny_root / "benchmark/families/ast.py").read_text()
    (tiny_root / "benchmark/families/half.py").write_text(src.split("\nhidden = ")[0])
    with pytest.raises(AttributeError, match="lacks hidden, pool, head"):
        load_family(tiny_root, {"model": {"family": "half"}})


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_drawn_as_before_families(name):
    """At the published widths: the family's shapes and fan-ins draw the
    tensors that ``transformer.param_shapes`` and a kernel's scale of
    1/sqrt(prod(shape[1:])) drew before, bit for bit."""
    cfg = load_json(ROOT / f"benchmark/configs/{name}.json")
    new = common.make_weights(load_family(ROOT, cfg), cfg["model"], SEED, "cpu")
    shapes = transformer.param_shapes(cfg["model"])
    assert list(new) == list(shapes)
    gen = torch.Generator().manual_seed(common.sub_seed(SEED, common.WEIGHTS))
    flat = torch.randn(sum(math.prod(s) for s, _ in shapes.values()), generator=gen)
    at = 0
    for n, (shape, kind) in shapes.items():
        z = flat[at: at + math.prod(shape)].view(shape)
        at += z.numel()
        if kind == "kernel":
            old = z / math.sqrt(math.prod(shape[1:]))
        elif kind == "scale":
            old = 1.0 + 0.1 * z
        else:
            old = 0.02 * z
        assert torch.equal(new[n], old), n


def old_least(model, sizes, kernels, peaks):
    """The rooflines' least seconds as they were counted before families:
    (kernel, B·H, T, D, calls) from ``yardstick.model_dims``, summed in the
    same order."""
    d = yardstick.model_dims(model)
    counts = {}
    for b in sizes:
        counts[b] = counts.get(b, 0) + 1
    least = 0.0
    for kind, bh, t, dim, calls in [(k, b * d["heads"], d["tokens"], d["head_dim"], n * d["layers"])
                                    for b, n in sorted(counts.items()) for k in kernels]:
        least += calls * yardstick.least_seconds(*yardstick.attention_work(kind, bh, t, dim), peaks)
    return least


@pytest.mark.parametrize("name", CONFIGS)
def test_kernel_work_reads_the_count_before_families(name):
    """A cell's training epoch and feature pass at the published sizes: the
    least seconds of the family's work entries equal, to the bit, the count
    the rooflines took from the model's shapes before."""
    cfg = load_json(ROOT / f"benchmark/configs/{name}.json")
    fam, model, sub, proto = (load_family(ROOT, cfg), cfg["model"], cfg["subject"],
                              cfg["protocol"])
    peaks = yardstick.card_peaks("NVIDIA H100 80GB HBM3")
    steps = [b - a for a, b in common.batches(sub["train"], proto["batch_size"])]
    evals = [b - a for n in (sub["train"], sub["test"])
             for a, b in common.batches(n, proto["eval_batch_size"])]
    for sizes, train, kernels in ((steps, True, ("fwd", "dkv", "dq")), (evals, False, ("fwd",))):
        work = fam.kernel_work(model, sizes, train)
        least = 0.0
        for _, flop, nbytes, calls in work:
            least += calls * yardstick.least_seconds(flop, nbytes, peaks)
        assert least == old_least(model, sizes, kernels, peaks)
        assert Counter(k for k, *_ in work) == \
            Counter({f"flash_{k}": len(set(sizes)) for k in kernels})


def test_the_answer_fault_alters_any_model_a_trainer_holds():
    """A plain ``nn.Module``: inside the block the first row of its every
    output comes out negated, through the trainer and called alone, and its
    hooks see it; after the block it answers as before."""
    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.train.loop import Trainer

    torch.manual_seed(0)
    model, x = torch.nn.Linear(4, 3), torch.randn(5, 4)
    with torch.no_grad():
        sound = model(x)
    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append(out.detach().clone()))
    with faults.plant("answer"):
        trainer = Trainer(model, get_preset("ast_finetune").finetune, device="cpu")
        got = torch.as_tensor(trainer.predict(x, batch_size=5))
        with torch.no_grad():
            alone = model(x)
    want = torch.cat([-sound[:1], sound[1:]])
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(alone, want)
    torch.testing.assert_close(seen[0], want)
    with torch.no_grad():
        torch.testing.assert_close(model(x), sound)
    assert "forward" not in vars(model)


def test_token_rows():
    """``"dtype": "int64"`` rows: ids uniform over [0, vocab) in the
    subject's shape, the same for the same seed and others for another;
    labels beside them as for the other rows."""
    cfg = {"subject": {"train": 40, "test": 24, "input": [16], "dtype": "int64",
                       "vocab": 50, "classes": 5}}
    tr_x, tr_y, te_x, te_y = common.make_subject(cfg, SEED, "cpu")
    assert tr_x.dtype == torch.int64 and tr_x.shape == (40, 16) and te_x.shape == (24, 16)
    ids = torch.cat([tr_x, te_x])
    assert int(ids.min()) >= 0 and int(ids.max()) < 50 and len(ids.unique()) == 50
    assert tr_y.shape == (40,) and int(torch.cat([tr_y, te_y]).max()) < 5
    again = common.make_subject(cfg, SEED, "cpu")
    assert all(torch.equal(a, b) for a, b in zip((tr_x, tr_y, te_x, te_y), again))
    assert not torch.equal(common.make_subject(cfg, SEED + 1, "cpu")[0], tr_x)
