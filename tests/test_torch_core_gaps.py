"""The port's small remaining counterparts of the reference's core API,
each against the reference on the same inputs, on the CPU: the
re-exports of ``core/__init__``, ``compress.quantize_tree`` /
``dequantize_tree``, ``reconstruct.make_reconstructor``,
``partition.stop_gradient_frozen``, the 1-D dispatcher
``kernels/ops.fake_quantize_flat`` and ``nn/basic.INITIALIZERS``.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core as jcore
from repro.core import compress as jcompress
from repro.core import partition as jpart
from repro.core import reconstruct as jrec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import basic as jbasic
import repro_torch.core as tcore
from repro_torch.core import compress as tcompress
from repro_torch.core import partition as tpart
from repro_torch.core import reconstruct as trec
from repro_torch.kernels import ops as tops
from repro_torch.nn import basic as tbasic


def _public(mod):
    return {n for n in dir(mod) if not n.startswith("_")}


def test_core_reexports_match_reference():
    want = _public(jcore) - {"jax", "jnp", "np"}
    assert want <= _public(tcore)
    for name in ("partition_params", "reconstruct_frozen", "merge",
                 "make_round_fn", "FlatLayout", "compile_plan",
                 "dp_ftrl_server_opt", "report_for"):
        assert callable(getattr(tcore, name))
    # the submodules stay reachable under their own names
    assert tcore.partition.partition is tcore.partition_params
    assert tcore.reconstruct.reconstruct is tcore.reconstruct_frozen


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"kernel": rng.normal(size=(5, 7)).astype(np.float32)},
            "b": rng.normal(size=(11,)).astype(np.float32) * 3.0}


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_matches_reference(bits):
    tree = _tree()
    jq, js = jcompress.quantize_tree(jax.tree_util.tree_map(jnp.asarray,
                                                            tree), bits)
    tq, ts = tcompress.quantize_tree(tbasic.tree_map(torch.from_numpy, tree),
                                     bits)
    for (path, a), (_, b) in zip(jbasic.flatten_params(jq),
                                 tbasic.flatten_params(tq)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=path)
        assert b.dtype == (torch.int8 if bits == 8 else torch.int32)
    for (_, a), (_, b) in zip(jbasic.flatten_params(js),
                              tbasic.flatten_params(ts)):
        assert np.asarray(a) == b.numpy()
    jd = jcompress.dequantize_tree(jq, js)
    td = tcompress.dequantize_tree(tq, ts)
    for (_, a), (_, b) in zip(jbasic.flatten_params(jd),
                              tbasic.flatten_params(td)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _jinit(seed):
    return {"dense": jbasic.init_dense(seed, "dense", 64, 4, jnp.float32,
                                       bias=True),
            "head": jbasic.init_dense(seed, "head", 4, 3, jnp.float32)}


def _tinit(seed, device=None):
    return {"dense": tbasic.init_dense(seed, "dense", 64, 4, torch.float32,
                                       bias=True, device=device),
            "head": tbasic.init_dense(seed, "head", 4, 3, torch.float32,
                                      device=device)}


def test_make_reconstructor_matches_reference():
    spec = (r"^dense/",)
    want = jrec.make_reconstructor(_jinit, 3, spec)()
    got = trec.make_reconstructor(_tinit, 3, spec, device="cpu")()
    assert [p for p, _ in tbasic.flatten_params(got)] == \
        [p for p, _ in jbasic.flatten_params(want)]
    for (_, a), (_, b) in zip(jbasic.flatten_params(want),
                              tbasic.flatten_params(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


def test_stop_gradient_frozen_matches_reference():
    full = _tinit(0, "cpu")
    y, z = tpart.partition(full, (r"^head/",))
    y = tbasic.tree_map(lambda t: t.clone().requires_grad_(True), y)
    z = tbasic.tree_map(lambda t: t.clone().requires_grad_(True), z)
    merged = tpart.stop_gradient_frozen(y, z)
    jy, jz = jpart.partition(_jinit(0), (r"^head/",))
    jm = jpart.stop_gradient_frozen(jy, jz)
    assert [p for p, _ in tbasic.flatten_params(merged)] == \
        [p for p, _ in jbasic.flatten_params(jm)]
    x = torch.ones(2, 64)
    out = tbasic.dense(tbasic.dense(x, merged["dense"]), merged["head"]).sum()
    out.backward()
    assert merged["head"]["kernel"].requires_grad is False
    assert z["head"]["kernel"].grad is None          # no gradient reaches z
    assert y["dense"]["kernel"].grad is not None


@pytest.mark.parametrize("rows", [None, 3])
def test_ops_fake_quantize_flat_matches_reference(rows):
    rng = np.random.default_rng(1)
    bl = np.asarray([0, 0, 1, 2, 2, 2], np.int32)
    shape = (bl.size * 1024,) if rows is None else (rows, bl.size * 1024)
    x = rng.normal(size=shape).astype(np.float32)
    # bit for bit the plain version the reference's dispatcher runs off
    # the TPU ...
    want = np.asarray(jref.fake_quantize_flat_ref(jnp.asarray(x), bl,
                                                  bits=8, n_leaves=3))
    got = tops.fake_quantize_flat(torch.from_numpy(x), bl, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # ... n_leaves read off the block map ...
    np.testing.assert_array_equal(
        tops.fake_quantize_flat(torch.from_numpy(x), bl).numpy(), want)
    # ... and within one float32 ulp of the dispatcher itself, whose jit
    # lets XLA rewrite the division by the scale
    jit = np.asarray(jops.fake_quantize_flat(jnp.asarray(x), jnp.asarray(bl),
                                             3))
    np.testing.assert_allclose(got.numpy(), jit, rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("name", ["normal", "zeros", "ones"])
def test_initializers_match_reference(name):
    assert set(tbasic.INITIALIZERS) == set(jbasic.INITIALIZERS)
    want = jbasic.INITIALIZERS[name](5, "w/kernel", (16, 8), jnp.float32)
    got = tbasic.INITIALIZERS[name](5, "w/kernel", (16, 8), torch.float32,
                                    device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
