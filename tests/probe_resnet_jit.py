"""Reads how far XLA's compiled (jitted) gradient of the JAX package's
ResNetAttn departs from the same gradient computed eagerly, op by op, in
float64 on the CPU, for several batch sizes; and, at each, the port's
float64 gradient against the eager one. Train mode, one step at 64 x 64 on
seeded normal inputs, the weights of ``JaxResNetAttn().init`` (seed 0).

The JAX package's ``TorchBatchNorm`` pins its statistics to float32; the
probe reads them in float64 through the same namespace swap as
tests/test_torch_resnet.py. A diagnostic, not a test:

    JAX_PLATFORMS=cpu python tests/probe_resnet_jit.py [batch ...]
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from eav_tpu.models import norm as jax_norm  # noqa: E402
from eav_tpu.models.resnet_attn import ResNetAttn as JaxResNetAttn  # noqa: E402
from eav_tpu.train.loop import cross_entropy as jax_cross_entropy  # noqa: E402
from eav_tpu_torch.models.bridge import resnet_attn_params_from_jax  # noqa: E402
from eav_tpu_torch.models.resnet_attn import ResNetAttn  # noqa: E402


class _Float64Numpy:
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _worst(a: dict, b: dict) -> float:
    """The largest entry of |a - b| over the leaves, each in units of b's
    largest entry."""
    return max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in b)


def main(batches) -> None:
    rng = np.random.default_rng(3)
    x_all = rng.normal(size=(max(batches), 64, 64, 3))
    variables = jax.tree.map(np.asarray, JaxResNetAttn().init(
        jax.random.PRNGKey(0), jnp.asarray(x_all[:1], jnp.float32)))
    params, stats = variables["params"], variables["batch_stats"]
    jax_norm.jnp = _Float64Numpy()
    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    for b in batches:
        x, y = jnp.asarray(x_all[:b]), jnp.asarray(np.arange(b) % 5)

        def loss(p):
            logits, _ = JaxResNetAttn().apply({"params": p, "batch_stats": stats}, x,
                                              train=True, mutable=["batch_stats"])
            return jax_cross_entropy(logits, y, jnp.ones(b, jnp.float32))

        def as_port(g):
            sd = resnet_attn_params_from_jax(jax.tree.map(np.asarray, g), stats)
            return {k: v.numpy() for k, v in sd.items()
                    if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}

        jitted = as_port(jax.jit(jax.grad(loss))(p64))
        eager = as_port(jax.grad(loss)(p64))
        m = ResNetAttn()
        m.load_state_dict(resnet_attn_params_from_jax(params, stats))
        m = m.double().train()
        F.cross_entropy(m(torch.from_numpy(np.asarray(x))),
                        torch.from_numpy(np.asarray(y)).long()).backward()
        port = {k: p.grad.numpy() for k, p in m.named_parameters()}
        print(f"batch {b}: jitted vs eager {_worst(jitted, eager):.3g}, "
              f"port vs eager {_worst(port, eager):.3g} of a leaf's largest entry", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2, 3, 4, 5, 8])
