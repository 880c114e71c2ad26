"""The port's DP-FTRL (``core/dp.tree_noise``, ``dp_ftrl_server_opt``)
against the JAX package, on the CPU.

Tolerances: the threefry keys and bits are JAX's; each Gaussian is within
4 ulps of JAX's (torch's and XLA's erfinv round differently,
``tests/test_torch_prng.py``), so a sum of popcount(t) <= 4 of them,
times sigma, is within 4 ulps of each term and the sums' rounding:
|noise - noise_ref| <= 2**-19 * popcount(t) * (max|noise| + sigma).
Drawing the set bits alone equals drawing all 30 levels bit for bit. The
optimizer's steps add the noise to float32 sums of the pseudo-gradients:
params within 1e-6 of max|params| after 3 steps.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.core import dp as jdp
from repro.nn import basic as jbasic
from repro_torch import bridge
from repro_torch.core import dp as tdp
from repro_torch.nn import basic as tbasic
from repro_torch.nn import threefry

SIGMA = 0.7


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.normal(size=(5, 33)).astype(np.float32),
                  "b": rng.normal(size=(33,)).astype(np.float32)},
            "c": rng.normal(size=(1000,)).astype(np.float32)}


def _all_levels(key, tree, sigma, t):
    """The reference's loop in the port's terms: all 30 levels drawn,
    each added as bit * z."""
    leaves = list(tbasic.flatten_params(tree))
    out = {}
    for (path, leaf), k in zip(leaves, threefry.split(key, len(leaves))):
        acc = torch.zeros(leaf.shape)
        for level in range(tdp.TREE_LEVELS):
            bit = float((t >> level) & 1)
            z = threefry.normal(threefry.fold_in(threefry.fold_in(k, level),
                                                 t >> level), leaf.shape)
            acc = acc + bit * z
        out[path] = sigma * acc
    return tbasic.unflatten_params(out)


@pytest.mark.parametrize("t", range(1, 10))
def test_tree_noise_matches_jax(t):
    tree = _tree(t)
    want = jdp.tree_noise(jax.random.key(5), jax.tree_util.tree_map(
        jnp.asarray, tree), SIGMA, t)
    got = tdp.tree_noise(threefry.key(5), bridge.from_numpy_tree(tree, "cpu"),
                         SIGMA, t)
    full = _all_levels(threefry.key(5), bridge.from_numpy_tree(tree, "cpu"),
                       SIGMA, t)
    pop = bin(t).count("1")
    for (path, w), (_, g), (_, f) in zip(jbasic.flatten_params(want),
                                         tbasic.flatten_params(got),
                                         tbasic.flatten_params(full)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        # the set bits alone: bit for bit the 30-level sum
        assert torch.equal(g.view(torch.int32), f.view(torch.int32)), path
        bound = 2.0 ** -19 * pop * float(np.abs(w).max() + SIGMA)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound,
                                   err_msg=path)


def test_tree_noise_refuses_a_step_past_the_tree():
    with pytest.raises(ValueError, match="outside"):
        tdp.tree_noise(threefry.key(0), {"a": torch.zeros(2)}, 1.0, 1 << 30)


def test_dp_ftrl_steps_match_jax():
    cfg = dict(lr=0.3, noise_multiplier=2.33, clip_norm=0.3,
               clients_per_round=16, momentum=0.9)
    jopt = jdp.dp_ftrl_server_opt(jdp.DPFTRLConfig(**cfg))
    topt = tdp.dp_ftrl_server_opt(tdp.DPFTRLConfig(**cfg))
    assert tdp.DPFTRLConfig(**cfg) == tdp.DPFTRLConfig(**cfg, seed=1234)
    params = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.from_numpy_tree(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda x: 0.01 * x, _tree(10 + step))
        jp, js = jopt.update(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                             js)
        tp, ts = topt.update(tp, bridge.from_numpy_tree(grads, "cpu"), ts)
    assert ts["t"] == int(js["t"]) == 3
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in jax.tree_util.tree_leaves(jp))
    for (path, w), (_, g) in zip(jbasic.flatten_params(jp),
                                 tbasic.flatten_params(tp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6 * scale, err_msg=path)
    for part in ("cumsum", "prev_priv", "m", "x0"):
        for (path, w), (_, g) in zip(jbasic.flatten_params(js[part]),
                                     tbasic.flatten_params(ts[part])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6 * scale, err_msg=part + path)
    assert tdp.NOISE_TO_EPS == jdp.NOISE_TO_EPS
    assert topt.name == jopt.name
