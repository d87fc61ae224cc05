"""The family ``ast``: the Audio Spectrogram Transformer (Gong, Chung and
Glass, arXiv:2104.01778), a patch-embedded pre-LN encoder over a fbank.

It gives the harness what ``harness.FAMILY`` names, standing on
``patch_encoder.py``, which it shares with ``vit``.
"""

from functools import partial

from benchmark import patch_encoder as enc

ARCH = "ast"  # the architecture reference/transformer.py and yardstick.py know

param_shapes = partial(enc.param_shapes, ARCH)
forward_flops = partial(enc.forward_flops, ARCH)
train_flops = partial(enc.train_flops, ARCH)
kernel_work = partial(enc.kernel_work, ARCH)
reference_blocks = partial(enc.reference_blocks, ARCH)
hidden = partial(enc.hidden, ARCH)
pool = partial(enc.pool, ARCH)
head = partial(enc.head, ARCH)
features = partial(enc.features, ARCH)
logits = partial(enc.logits, ARCH)
hidden_module = enc.hidden_module
