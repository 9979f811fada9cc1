"""PanoHead's t_mapping and background synthesis for the JAX param trees
that port tests build part by part.

The port's TriPlaneGenerator carries both sub-networks, as the JAX
package's init does, and its loaders (port/from_jax.py) load them strictly.
A tree built from backbone, decoder and torgb alone gains them here. These
tests never evaluate them, so their weights are seeded numpy normals in the
shapes of JAX's init (jax.eval_shape: traced, not compiled), and the other
parts keep the weights they had."""
import jax
import jax.numpy as jnp
import numpy as np


def with_gan_parts(jg, params, seed=5):
    """params (a generator param tree, as a dict) plus jg's t_mapping and
    bcg_synthesis where jg has them."""
    rng = np.random.RandomState(seed)
    p = dict(params)
    for name in ("t_mapping", "bcg_synthesis"):
        net = getattr(jg, name)
        if net is not None:
            shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0))
            p[name] = jax.tree.map(
                lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)), shapes)
    return p
