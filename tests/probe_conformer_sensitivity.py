"""Reads how far a roundoff-sized change of the inputs moves the JAX
package's EEG conformer fit, beside the port's reading of the same
perturbation (``eav_tpu_torch/scripts/fit_sensitivity.py``): the
``conformer_eeg`` preset (Adam at lr 1e-3, batch 32, the double softmax,
head max-norm 0.5, dropout 0.5) cut to ``epochs``, fit by ``JitTrainer`` on
the CPU in float32 twice under one seed, once on the train trials as drawn
and once on them scaled by 1 + 1e-6, then the max |difference| of the two
fits' test logits. The data are the port script's: noise from
``default_rng(0)``, 280 train and 60 test trials of 30 x 500, the classes
in blocks. With ``--port`` the port's script runs too, in this process, on
the CPU. A diagnostic, not a test:

    JAX_PLATFORMS=cpu python tests/probe_conformer_sensitivity.py \\
        [--layers 12 2] [--epochs 2] [--port]
"""

import argparse
import dataclasses
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from eav_tpu.core.config import get_preset  # noqa: E402
from eav_tpu.models.conformer_eeg import ConformerEEG  # noqa: E402
from eav_tpu.train.loop import JitTrainer  # noqa: E402


def jax_run(train: int = 280, epochs: int = 2, layers: int = 12, seed: int = 1) -> dict:
    """The port script's ``run`` through ``JitTrainer``."""
    rng = np.random.default_rng(0)
    tr_x = rng.normal(size=(train, 30, 500)).astype(np.float32)
    tr_y = np.repeat(np.arange(5), train // 5).astype(np.int32)
    te_x = rng.normal(size=(60, 30, 500)).astype(np.float32)
    te_y = np.repeat(np.arange(5), 12).astype(np.int32)
    base = get_preset("conformer_eeg").finetune
    cfg = dataclasses.replace(base, phases=(dataclasses.replace(base.phases[0], epochs=epochs),))
    model = ConformerEEG(num_layers=layers, dropout=0.5)
    trainer = JitTrainer(model, cfg, maxnorm_rules=model.maxnorm_rules)
    a = trainer.fit((tr_x, tr_y, te_x, te_y), seed=seed)
    b = trainer.fit((tr_x * np.float32(1 + 1e-6), tr_y, te_x, te_y), seed=seed)
    out_a, out_b = np.asarray(a.outputs_test), np.asarray(b.outputs_test)
    return {"train": train, "epochs": epochs, "layers": layers,
            "max_abs_diff": float(np.abs(out_a - out_b).max()),
            "logit_scale": float(np.abs(out_a).max()),
            "loss": [np.asarray(a.history["loss"]).tolist(),
                     np.asarray(b.history["loss"]).tolist()]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12, 2])
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--port", action="store_true", help="run the port's script beside it")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    for layers in args.layers:
        print(json.dumps({"jax": jax_run(epochs=args.epochs, layers=layers)}), flush=True)
        if args.port:
            from eav_tpu_torch.scripts.fit_sensitivity import run

            print(json.dumps({"port": run("cpu", epochs=args.epochs, layers=layers)}),
                  flush=True)


if __name__ == "__main__":
    main()
