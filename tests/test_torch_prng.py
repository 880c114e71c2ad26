"""The threefry port (``repro_torch/nn/threefry.py``) against ``jax.random``
in partitionable mode: raw bits and uniforms bit for bit, normals and
the path-keyed init within a few ulps (the erfinv polynomial's log1p and
fused multiply-adds round differently in torch and XLA); a draw taken in
several pieces (``threefry.PIECE`` set small) bit for bit the whole draw.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable)
import jax
import jax.numpy as jnp

from repro.models import paper_models as jpm
from repro.nn import basic as jbasic
from repro_torch.models import paper_models as tpm
from repro_torch.nn import basic as tbasic
from repro_torch.nn import threefry

SEEDS = (0, 1, 42, 2**31 + 5, -3)
SHAPES = ((1,), (7,), (3, 5), (2, 3, 4), (1000,))
# normals: torch's and XLA's log1p / fma differ by an ulp or two, and
# the stddev multiply may add one more
ULPS = 4


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _key_data(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


def test_threefry_partitionable_mode_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    assert threefry.key(seed) == _key_data(jax.random.key(seed))
    for data in (0, 1, 12345, 0x7FFFFFFF):
        assert threefry.fold_in(threefry.key(seed), data) == _key_data(
            jax.random.fold_in(jax.random.key(seed), data))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_match_jax_bitwise(seed, shape):
    jk = jax.random.fold_in(jax.random.key(seed), 99)
    tk = threefry.fold_in(threefry.key(seed), 99)
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    got = threefry.random_bits(tk, shape).numpy()
    np.testing.assert_array_equal(got, want)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    tu = threefry.uniform(tk, shape).numpy()
    np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))


@pytest.mark.parametrize("path", ["conv1/kernel", "dense1/kernel", "gn/scale",
                                  "layer0/ffn1/kernel"])
@pytest.mark.parametrize("seed", (0, 7))
def test_path_key_matches_jax(path, seed):
    assert tbasic.path_key(seed, path) == _key_data(
        jbasic.path_key(seed, path))


@pytest.mark.parametrize("shape,fan_in", [((4000,), None), ((5, 5, 1, 32), 25),
                                          ((64, 62), 64)])
def test_normal_init_within_ulps(shape, fan_in):
    want = np.asarray(jbasic.normal_init(3, "a/b", shape, jnp.float32,
                                         fan_in=fan_in))
    got = tbasic.normal_init(3, "a/b", shape, torch.float32, fan_in=fan_in,
                             device="cpu").numpy()
    assert got.shape == want.shape
    assert _ulps(got, want) <= ULPS


def test_emnist_init_matches_jax_leaf_by_leaf():
    want = dict(jbasic.flatten_params(jpm.init_emnist_cnn(0)))
    got = dict(tbasic.flatten_params(tpm.init_emnist_cnn(0, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        assert _ulps(g, np.asarray(w)) <= ULPS, path


@pytest.mark.parametrize("piece", [7, 64, 1000])
@pytest.mark.parametrize("shape", [(3, 5, 17), (1000,), (64, 31)])
def test_a_draw_in_pieces_is_the_whole_draw(monkeypatch, shape, piece):
    """Bits, uniforms (float32 and bf16) and normals filled ``piece``
    elements at a time (a shape past the piece, with a ragged last piece,
    or within one) equal the one-piece draw bit for bit, and the bits and
    uniforms still equal JAX's."""
    tk = threefry.fold_in(threefry.key(11), 5)
    jk = jax.random.fold_in(jax.random.key(11), 5)
    draws = {
        "bits": lambda: threefry.random_bits(tk, shape),
        "uniform": lambda: threefry.uniform(tk, shape),
        "uniform_bf16": lambda: threefry.uniform(tk, shape,
                                                 dtype=torch.bfloat16),
        "normal": lambda: threefry.normal(tk, shape),
    }
    whole = {name: fn() for name, fn in draws.items()}
    monkeypatch.setattr(threefry, "PIECE", piece)
    for name, fn in draws.items():
        got = fn()
        assert got.shape == shape and got.dtype == whole[name].dtype
        assert torch.equal(got.view(-1).view(torch.uint8),
                           whole[name].view(-1).view(torch.uint8)), name
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    np.testing.assert_array_equal(threefry.random_bits(tk, shape).numpy(), want)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    np.testing.assert_array_equal(
        threefry.uniform(tk, shape).numpy().view(np.int32), ju.view(np.int32))
    jn = np.asarray(jax.random.normal(jk, shape, jnp.float32))
    assert _ulps(threefry.normal(tk, shape).numpy(), jn) <= ULPS
