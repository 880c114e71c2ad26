"""The port's trainability plans (``repro_torch.core.plan``), the flat
layout's block sub-layouts, ``partition_plan`` / ``summarize_plan`` and
``wire.tier_payloads`` against the JAX package's, on the same trees.

Everything here is host statics or data movement, so it is held
exactly: the compiled plan's leaf selection, block ids, sizes, parameter
counts and byte counts equal; gather and scatter bit for bit the
reference's (and a round trip); ``summarize_plan`` rows equal; the wire
payloads byte for byte. The one float reduction, ``block_masked_mean``,
is held within rtol 1e-6 plus 2 ulps of max|mean| (a float32 matmul over
4 rows, reduced in another order), and bit for bit its staged use.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.core import flat as jflat
from repro.core import plan as jplan
from repro.models import paper_models as jpm
from repro.nn import basic as jbasic
from repro.sim import wire as jwire
from repro_torch import bridge
from repro_torch.core import flat as tflat
from repro_torch.core import partition as tpart
from repro_torch.core import plan as tplan
from repro_torch.nn import basic as tbasic
from repro_torch.sim import wire as twire


def small_init(seed):
    return {"enc": jbasic.init_dense(seed, "enc", 48, 16, jnp.float32,
                                     bias=True),
            "head": jbasic.init_dense(seed + 1, "head", 16, 4, jnp.float32,
                                      bias=True)}


SMALL_PLAN = {"full": (), "mid": (r"^head/",), "lite": (r"^head/", r"/bias$")}
EMNIST_PLAN = {"full": (), "mid": (r"^conv2/",),
               "lite": (r"^conv1/", r"^conv2/")}
# (init, global freeze spec, plan)
CASES = {
    "small": (small_init, (), SMALL_PLAN),
    "emnist": (jpm.init_emnist_cnn, jpm.EMNIST_FREEZE, EMNIST_PLAN),
    "emnist_fedavg": (jpm.init_emnist_cnn, (), EMNIST_PLAN),
}


def both_params(name):
    init, spec, plan = CASES[name]
    params = jax.tree_util.tree_map(np.asarray, init(0))
    return params, bridge.from_numpy_tree(params, "cpu"), spec, plan


def both_plans(name):
    jp, tp, spec, plan = both_params(name)
    jy, _ = jpart.partition(jp, spec)
    ty, _ = tpart.partition(tp, spec)
    return jplan.compile_plan(plan, jy), tplan.compile_plan(plan, ty), jy, ty


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_compiles_to_the_reference(name):
    jcp, tcp, _, _ = both_plans(name)
    assert tcp.names == jcp.names and tcp.trivial == jcp.trivial
    assert tcp.paths == jcp.paths
    assert tcp.layout.size == jcp.layout.size
    for jt, tt in zip(jcp.tiers, tcp.tiers):
        assert (tt.name, tt.index, tt.freeze_spec, tt.leaf_on) == (
            jt.name, jt.index, jt.freeze_spec, jt.leaf_on)
        np.testing.assert_array_equal(tt.block_ids, jt.block_ids)
        assert tt.block_ids.dtype == np.int32
        assert (tt.size, tt.num_blocks, tt.param_count, tt.trainable_bytes) \
            == (jt.size, jt.num_blocks, jt.param_count, jt.trainable_bytes)
    np.testing.assert_array_equal(tcp.block_masks(), jcp.block_masks())
    np.testing.assert_array_equal(tcp.block_masks_on("cpu").numpy(),
                                  jcp.block_masks())
    for jm, tm in zip(jcp.leaf_masks(), tcp.leaf_masks()):
        for (pa, a), (pb, b) in zip(jbasic.flatten_params(jm),
                                    tbasic.flatten_params(tm)):
            assert pa == pb and b.dtype == torch.float32
            assert float(b) == float(a) and b.device.type == "cpu"


def test_emnist_tier_widths():
    """The tier lanes the card runs: 87 blocks in all under EMNIST_FREEZE,
    ``mid`` 36 (conv2's 51 frozen), ``lite`` 34 (conv1's one as well)."""
    _, tcp, _, _ = both_plans("emnist")
    assert [t.size for t in tcp.tiers] == [89_088, 36_864, 34_816]
    _, tcp, _, _ = both_plans("emnist_fedavg")
    assert tcp.layout.size == 1_695_744


def test_train_plan_construction_and_refusals():
    assert tplan.TrainPlan.of(SMALL_PLAN).names == ("full", "mid", "lite")
    p = tplan.TrainPlan.of(SMALL_PLAN)
    assert tplan.TrainPlan.of(p) is p
    q = tplan.TrainPlan.of([("a", ()), tplan.Tier("b", (r"x",))])
    assert q.names == ("a", "b") and len(tplan.TrainPlan.single()) == 1
    with pytest.raises(ValueError, match="duplicate"):
        tplan.TrainPlan.of([("a", ()), ("a", ())])
    with pytest.raises(ValueError, match="at least one"):
        tplan.TrainPlan(())
    _, _, _, ty = both_plans("small")
    with pytest.raises(ValueError, match="every trainable"):
        tplan.compile_plan({"dead": (r".",)}, ty)
    assert tplan.compile_plan(tplan.TrainPlan.single(), ty).trivial
    assert not tplan.compile_plan({"only": (r"/bias$",)}, ty).trivial
    assert not tplan.compile_plan({"a": (), "b": ()}, ty).trivial
    empty = tplan.compile_plan(tplan.TrainPlan.single(), {})
    assert empty.trivial and empty.tiers[0].size == 0


@pytest.mark.parametrize("name", ["small", "emnist"])
def test_gather_scatter_match_jax_and_round_trip(name):
    jcp, tcp, _, _ = both_plans(name)
    vec = np.random.default_rng(0).normal(
        size=jcp.layout.size).astype(np.float32)
    mat = np.stack([vec, 2 * vec, -vec])
    for jt, tt in zip(jcp.tiers, tcp.tiers):
        for x in (vec, mat):
            sub = tcp.gather(torch.from_numpy(x), tt)
            np.testing.assert_array_equal(sub.numpy(),
                                          np.asarray(jcp.gather(x, jt)))
            back = tcp.scatter(sub, tt)
            np.testing.assert_array_equal(
                back.numpy(), np.asarray(jcp.scatter(jnp.asarray(sub.numpy()),
                                                     jt)))
            mask = tflat.expand_block_mask(
                tcp.layout.block_mask(tt.leaf_on), tcp.layout.align)
            np.testing.assert_array_equal(back.numpy(), x * mask.numpy())
            # the round trip: gather(scatter(sub)) is sub
            assert torch.equal(tcp.gather(back, tt), sub)
        # with numpy ids, as the reference's functions take them
        np.testing.assert_array_equal(
            tflat.gather_blocks(torch.from_numpy(vec), tt.block_ids).numpy(),
            np.asarray(jflat.gather_blocks(jnp.asarray(vec), jt.block_ids)))


@pytest.mark.parametrize("name", ["small", "emnist"])
def test_split_flattens_to_the_gathered_slice(name):
    """A tier subtree's own FlatLayout is the contiguous block slice:
    flatten(split) == gather(flatten(y)), and the halves merge back."""
    _, tcp, _, ty = both_plans(name)
    gvec = tcp.layout.flatten(ty)
    for t in tcp.tiers:
        y_t, extra = tcp.split(ty, t)
        lt = tflat.FlatLayout.of(y_t)
        assert lt.size == t.size
        assert torch.equal(lt.flatten(y_t), tcp.gather(gvec, t))
        merged = tpart.merge(y_t, extra)
        for (pa, a), (pb, b) in zip(tbasic.flatten_params(ty),
                                    tbasic.flatten_params(merged)):
            assert pa == pb and torch.equal(a, b)


def test_flat_block_helpers_match_jax():
    jcp, tcp, _, _ = both_plans("emnist")
    jl, tl = jcp.layout, tcp.layout
    for on in ([True] * len(tl.sizes), jcp.tiers[2].leaf_on,
               [i % 2 == 0 for i in range(len(tl.sizes))]):
        np.testing.assert_array_equal(tl.leaf_blocks(on), jl.leaf_blocks(on))
        np.testing.assert_array_equal(tl.block_mask(on), jl.block_mask(on))
        np.testing.assert_array_equal(
            tflat.expand_block_mask(tl.block_mask(on)).numpy(),
            np.asarray(jflat.expand_block_mask(jl.block_mask(on))))
    with pytest.raises(ValueError, match="leaf_on"):
        tl.leaf_blocks([True])
    g = np.random.default_rng(1)
    bm = jcp.block_masks()[[0, 2, 1, 2]]
    mat = (g.normal(size=(4, tl.size)).astype(np.float32).reshape(
        4, -1, tl.align) * bm[:, :, None]).reshape(4, -1)
    w = np.array([3.0, 1.0, 0.5, 2.0], np.float32)
    want = np.asarray(jflat.block_masked_mean(jnp.asarray(mat), jnp.asarray(w),
                                              jnp.asarray(bm), tl.align))
    got = tflat.block_masked_mean(torch.from_numpy(mat), torch.from_numpy(w),
                                  torch.from_numpy(bm), tl.align).numpy()
    tol = 1e-6 * np.abs(want) + 2 * np.spacing(np.abs(want).max())
    assert (np.abs(got - want) <= tol).all()
    # all-ones masks reduce it to the weighted mean (the same division
    # by the same float32 weight sum)
    ones = torch.ones((4, tl.num_blocks))
    np.testing.assert_array_equal(
        tflat.block_masked_mean(torch.from_numpy(mat), torch.from_numpy(w),
                                ones, tl.align).numpy(),
        tflat.weighted_mean(torch.from_numpy(mat), torch.from_numpy(w),
                            torch.from_numpy(w).sum()).numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_partition_and_summarize_plan_match_jax(name):
    jp, tp, spec, plan = both_params(name)
    jcp, jsplits = jpart.partition_plan(jp, spec, plan)
    tcp, tsplits = tpart.partition_plan(tp, spec, plan)
    assert [t.leaf_on for t in tcp.tiers] == [t.leaf_on for t in jcp.tiers]
    for (jy, jz), (ty, tz) in zip(jsplits, tsplits):
        assert [p for p, _ in tbasic.flatten_params(ty)] == \
            [p for p, _ in jbasic.flatten_params(jy)]
        assert [p for p, _ in tbasic.flatten_params(tz)] == \
            [p for p, _ in jbasic.flatten_params(jz)]
    assert tpart.summarize_plan(tp, spec, plan) == \
        jpart.summarize_plan(jp, spec, plan)
    # the one-tier row is summarize
    assert tpart.summarize(tp, spec) == jpart.summarize(jp, spec)


@pytest.mark.parametrize("bits", [0, 8, 4])
@pytest.mark.parametrize("name", ["small", "emnist"])
def test_tier_payloads_bytes_equal(name, bits):
    jcp, tcp, jy, ty = both_plans(name)
    got = twire.tier_payloads(ty, tcp, bits)
    assert got == jwire.tier_payloads(jy, jcp, bits)
    assert got[tcp.names[0]]["up"] > got[tcp.names[-1]]["up"]
    assert len({p["down"] for p in got.values()}) == 1
