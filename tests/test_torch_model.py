"""The port's EMNIST CNN and FedPT partitioning against the JAX package:
forward logits on the reference's own parameters (carried across by
``repro_torch.bridge``), the paper's trainable fraction, and the
reconstruct round trip.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.models import paper_models as jpm
from repro.nn import basic as jbasic
from repro.nn import conv as jconv
from repro_torch import bridge
from repro_torch.core import partition as tpart
from repro_torch.core import reconstruct as trec
from repro_torch.models import paper_models as tpm
from repro_torch.nn import basic as tbasic
from repro_torch.nn import conv as tconv

# float32 convolutions and 3136-long dot products summed in another
# order by XLA:CPU and by torch's CPU kernels
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jpm.init_emnist_cnn(0)


def test_bridge_roundtrip(jax_params):
    tree = bridge.from_numpy_tree(jax_params, device="cpu")
    back = bridge.to_numpy_tree(tree)
    want = dict(jbasic.flatten_params(jax_params))
    got = dict(tbasic.flatten_params(back))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert got[k].dtype == np.float32


def test_emnist_forward_matches_jax(jax_params):
    images = np.random.default_rng(0).normal(
        size=(8, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jpm.emnist_cnn_forward(jax_params, jnp.asarray(images)))
    params = bridge.from_numpy_tree(jax_params, device="cpu")
    got = tpm.emnist_cnn_forward(params, torch.from_numpy(images))
    assert got.shape == (8, 62)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (1, "VALID"),
                                            (2, "VALID")])
def test_conv2d_layout_matches_jax(stride, padding):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 9, 3)).astype(np.float32)
    p = {"kernel": rng.normal(size=(3, 3, 3, 5)).astype(np.float32),
         "bias": rng.normal(size=(5,)).astype(np.float32)}
    want = np.asarray(jconv.conv2d(jnp.asarray(x), p, stride, padding))
    got = tconv.conv2d(torch.from_numpy(x),
                       bridge.from_numpy_tree(p, device="cpu"), stride,
                       padding)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        tconv.maxpool2d(torch.from_numpy(x)).numpy(),
        np.asarray(jconv.maxpool2d(jnp.asarray(x))))


def test_groupnorm_matches_jax():
    x = np.random.default_rng(2).normal(size=(3, 4, 4, 8)).astype(np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 8, dtype=np.float32),
         "bias": np.linspace(-1, 1, 8, dtype=np.float32)}
    want = np.asarray(jconv.apply_groupnorm(jnp.asarray(x), p, groups=2))
    got = tconv.apply_groupnorm(torch.from_numpy(x),
                                bridge.from_numpy_tree(p, device="cpu"),
                                groups=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_partition_counts_match_paper_and_jax(jax_params):
    params = tpm.init_emnist_cnn(0, device="cpu")
    y, z = tpart.partition(params, tpm.EMNIST_FREEZE)
    assert tpart.count_params(y) == 84_030
    assert tpart.count_params(y) + tpart.count_params(z) == 1_690_174
    frac = tpart.trainable_fraction(params, tpm.EMNIST_FREEZE)
    assert frac == pytest.approx(
        jpart.trainable_fraction(jax_params, jpm.EMNIST_FREEZE), abs=0)
    assert round(100 * frac, 2) == 4.97
    jy, _ = jpart.partition(jax_params, jpm.EMNIST_FREEZE)
    assert [p for p, _ in tbasic.flatten_params(y)] == [
        p for p, _ in jbasic.flatten_params(jy)]


def test_verify_roundtrip_and_reconstruct():
    assert trec.verify_roundtrip(tpm.init_emnist_cnn, 0, tpm.EMNIST_FREEZE,
                                 device="cpu")
    y, z = trec.init_partitioned(tpm.init_emnist_cnn, 0, tpm.EMNIST_FREEZE,
                                 device="cpu")
    z2 = trec.reconstruct(tpm.init_emnist_cnn, 0, tpm.EMNIST_FREEZE,
                          device="cpu")
    assert torch.equal(z["dense1"]["kernel"], z2["dense1"]["kernel"])
    merged = tpart.merge(y, z)
    assert sorted(merged) == ["conv1", "conv2", "dense1", "dense2", "gn"]
