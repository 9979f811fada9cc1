"""JAX's draws for the port's GAN step and augment pipe.

The port's functions take a draws object (gaussian_gan_decoder_tpu_torch/
utils/draws.py): `child(name)` for a named sub-site, then `uniform`,
`normal` or `randint`, one draw a call. JaxDraws answers with the keys the
JAX package's functions split at the same sites, so the port sees JAX's
draws bit for bit: `seq(key, n)` is a site that splits its key n ways and
draws from the next key at each call (augment_pipe's 40 keys, the
renderer's stratified and importance keys); `leaf(key)` is a site that
draws once from its own key; `node(children)` names sub-sites.
"""
import jax
import numpy as np
import torch


class JaxDraws:
    def __init__(self, keys=None, children=None):
        self._keys = list(keys or [])
        self._children = dict(children or {})

    def child(self, name):
        return self._children[name]

    def _next(self):
        return self._keys.pop(0)

    # f32 draws whatever the session's jax_enable_x64, as the JAX step draws
    def uniform(self, shape):
        with jax.enable_x64(False):
            return torch.tensor(np.asarray(jax.random.uniform(self._next(), tuple(shape))))

    def normal(self, shape):
        with jax.enable_x64(False):
            return torch.tensor(np.asarray(jax.random.normal(self._next(), tuple(shape))))

    def randint(self, shape, low, high):
        with jax.enable_x64(False):
            r = jax.random.randint(self._next(), tuple(shape), low, high)
        return torch.tensor(np.asarray(r), dtype=torch.int64)


def leaf(key):
    return JaxDraws([key])


def seq(key, n):
    return JaxDraws(list(jax.random.split(key, n)))


def node(**children):
    return JaxDraws(children=children)


def run_g_draws(key):
    """train/gan.py run_G: k_swap, k_render = split(key)."""
    k_swap, k_render = jax.random.split(key)
    return node(swap=leaf(k_swap), render=seq(k_render, 2))


def run_d_draws(key, augment: bool):
    """train/gan.py run_D: with an augment, k_aug, key = split(key); the
    augment splits k_aug 40 ways; D's conditioning noise takes key."""
    kids = {}
    if augment:
        k_aug, key = jax.random.split(key)
        kids["aug"] = seq(k_aug, 40)
    kids["noise"] = leaf(key)
    return node(**kids)


def gan_step_draws(key, augment: bool = False):
    """The draws of one make_gan_train_step step under `key`: the G phase
    ('g': run_G, run_D, the density regulariser's three keys) and the D
    phase ('d': run_G, the fake, real and R1 D calls)."""
    k_g, k_d = jax.random.split(key)
    kg_g, kg_d, k_reg = jax.random.split(k_g, 3)
    k1, k2, k3 = jax.random.split(k_reg, 3)
    g = node(G=run_g_draws(kg_g), D=run_d_draws(kg_d, augment),
             reg=node(pts=leaf(k1), perturb=leaf(k2), swap=leaf(k3)))
    kd_g, k_d1, k_d2, k_r1 = jax.random.split(k_d, 4)
    d = node(G=run_g_draws(kd_g), fake=run_d_draws(k_d1, augment),
             real=run_d_draws(k_d2, augment), r1=run_d_draws(k_r1, augment))
    return node(g=g, d=d)
