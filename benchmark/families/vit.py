"""The family ``vit``: the Vision Transformer (Dosovitskiy et al.,
arXiv:2010.11929), a patch-embedded pre-LN encoder over uint8 frames.

It gives the harness what ``harness.FAMILY`` names, standing on
``patch_encoder.py``, which it shares with ``ast``.
"""

from functools import partial

from benchmark import patch_encoder as enc

ARCH = "vit"  # the architecture reference/transformer.py and yardstick.py know

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
