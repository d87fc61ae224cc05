"""How far a roundoff-sized change of the inputs moves a fit: the EEG
conformer's serial fit at full width (30 electrodes x 500 samples) run twice
under one seed, once on the train trials as drawn and once on them scaled by
1 + 1e-6, then the max |difference| of the two fits' test logits.

    python -m eav_tpu_torch.scripts.fit_sensitivity --device cpu \\
        [--train 280] [--epochs 2] [--layers 12]

The fine-tune config is the ``conformer_eeg`` preset's (Adam at lr 1e-3,
batch 32, the double softmax, head max-norm 0.5, dropout 0.5) cut to
``epochs``; the data are noise from a seed (``train`` trials, 60 test
trials, the classes in blocks). Two computations of this fit that differ only in roundoff, such as
a stacked and a serial one, part about as far as the two fits here: this is
why ``chip_smoke.py`` holds the stacked conformer to its serial fit over one
step and over a fit of 2 steps, not over the 18 steps of 2 full epochs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def run(device="cuda", train: int = 280, epochs: int = 2, layers: int = 12, seed: int = 1) -> dict:
    """-> {"max_abs_diff": test-logit distance, "loss": both fits' loss histories, ...}."""
    import numpy as np

    from eav_tpu_torch.core.config import get_preset
    from eav_tpu_torch.models.conformer_eeg import ConformerEEG
    from eav_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    tr_x = rng.normal(size=(train, 30, 500)).astype(np.float32)
    tr_y = np.repeat(np.arange(5), train // 5)
    te_x = rng.normal(size=(60, 30, 500)).astype(np.float32)
    te_y = np.repeat(np.arange(5), 12)
    base = get_preset("conformer_eeg").finetune
    cfg = dataclasses.replace(base, phases=(dataclasses.replace(base.phases[0], epochs=epochs),))
    trainer = Trainer(ConformerEEG(num_layers=layers, dropout=0.5), cfg, device=device)
    a = trainer.fit((tr_x, tr_y, te_x, te_y), seed=seed)
    b = trainer.fit((tr_x * np.float32(1 + 1e-6), tr_y, te_x, te_y), seed=seed)
    return {"train": train, "epochs": epochs, "layers": layers,
            "max_abs_diff": float(np.abs(a.outputs_test - b.outputs_test).max()),
            "loss": [a.history["loss"].tolist(), b.history["loss"].tolist()]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--train", type=int, default=280)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    print(json.dumps(run(**vars(args))))


if __name__ == "__main__":
    main()
