"""``threefry.gumbel`` / ``categorical`` and sampled decoding against
``jax.random``, on the CPU.

Tolerances: the uniform's bits are JAX's exactly in every type (the
16-bit types draw the low 8 or 16 bits of each 32-bit word); the Gumbel
draws are within ``threefry.gumbel_tolerance``, 2 eps (1 + |g|) (each
library's log is within one ulp), in float32 and bfloat16 (float16, which
no caller draws, is held to the uniform's bits only: XLA:CPU's float16
logs lie up to 4 ulps from torch's on these draws); the sampled tokens
are equal on these inputs, in float32 and in bfloat16, and so are the
tokens of
``generate(temperature=0.7)`` on the reduced Mistral-NeMo.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch.train import reduced_config as jreduced
from repro.models import decoder_lm as jdlm
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.nn import threefry

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _bits(x):
    """The raw bits of a float array as unsigned integers."""
    x = np.asarray(x)
    return x.view({4: np.uint32, 2: np.uint16}[x.dtype.itemsize])


def _torch_bits(t):
    width = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.float16: torch.int16}[t.dtype]
    return t.view(width).numpy().view({torch.int32: np.uint32,
                                       torch.int16: np.uint16}[width])


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_bits_equal_jax(name, seed):
    jdt, tdt = DTYPES[name]
    shape = (3, 1000)
    lo = float(jnp.finfo(jdt).tiny)
    want = jax.random.uniform(jax.random.key(seed), shape, jdt, lo, 1.0)
    got = threefry.uniform(threefry.key(seed), shape, lo, 1.0, dtype=tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_gumbel_within_ulp_bound_of_jax(name):
    jdt, tdt = DTYPES[name]
    shape = (4, 5000)
    want = np.asarray(jax.random.gumbel(jax.random.key(3), shape, jdt)
                      .astype(jnp.float32))
    got = threefry.gumbel(threefry.key(3), shape, tdt)
    assert got.dtype == tdt
    tol = threefry.gumbel_tolerance(torch.tensor(want).to(tdt)).numpy()
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    if name == "bfloat16":
        # every op rounds to bf16 in both packages: the same bits here
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_tokens_equal_jax(name, seed):
    jdt, tdt = DTYPES[name]
    logits = np.random.default_rng(seed).normal(
        scale=3.0, size=(16, 2000)).astype(np.float32)
    jl = jnp.asarray(logits).astype(jdt)
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jl))
    got = threefry.categorical(threefry.key(seed),
                               torch.from_numpy(logits).to(tdt))
    assert got.dtype == torch.int32 and got.shape == (16,)
    np.testing.assert_array_equal(got.numpy(), want)
    # along another axis too
    want = np.asarray(jax.random.categorical(jax.random.key(seed), jl.T,
                                             axis=0))
    got = threefry.categorical(threefry.key(seed),
                               torch.from_numpy(logits.T.copy()).to(tdt),
                               axis=0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_follows_the_distribution():
    probs = np.array([0.1, 0.2, 0.7])
    logits = torch.log(torch.tensor(probs, dtype=torch.float32)).repeat(
        20000, 1)
    draws = threefry.categorical(threefry.key(11), logits).numpy()
    freq = np.bincount(draws, minlength=3) / len(draws)
    # 20,000 draws: the standard error is at most 0.0035
    np.testing.assert_allclose(freq, probs, atol=0.015)


def test_generate_sampled_tokens_equal_jax():
    jcfg = jreduced(jget("mistral-nemo-12b")).with_(num_kv_heads=2)
    tcfg = tbase.ModelConfig(**dataclasses.asdict(jcfg))
    jparams = jdlm.init_model(jcfg, 0)
    params = bridge.from_numpy_tree(jparams, device="cpu")
    prompt = np.random.default_rng(5).integers(0, 512, (3, 5), dtype=np.int32)
    for temperature, seed in ((0.7, 0), (1.0, 4)):
        want = np.asarray(jserve.generate(jparams, jcfg, jnp.asarray(prompt),
                                          12, temperature=temperature,
                                          seed=seed))
        got = tserve.generate(params, tcfg, prompt, 12,
                              temperature=temperature, seed=seed,
                              device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    greedy = tserve.generate(params, tcfg, prompt, 12, device="cpu")
    assert not torch.equal(greedy, got)
