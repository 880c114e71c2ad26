"""The port's flat data plane against the JAX package: the EMNIST
``FlatLayout``, the plain versions of the three kernels against the
Pallas kernels run with ``interpret=True`` (bit for bit for max-abs and
Q->DQ, including an all-zero leaf, NaN and Inf; rtol 1e-5 for sumsq),
``compress``, and the staged server tail, with the trainability-tier
arguments on both routes.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.core import compress as jcompress
from repro.core import flat as jflat
from repro.kernels import dp_clip as jdp
from repro.kernels import ops as jops
from repro.kernels import quantize as jq
from repro.models import paper_models as jpm
from repro_torch import bridge, kernels
from repro_torch.core import compress as tcompress
from repro_torch.core import flat as tflat
from repro_torch.kernels import dp_clip as tdp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from repro_torch.nn import basic as tbasic


def same_bits(a, b) -> bool:
    """Equal NaN positions, identical float32 bits everywhere else."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    keep = ~np.isnan(a)
    return np.array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


@pytest.fixture(scope="module")
def emnist_y():
    y, _ = jpart.partition(jpm.init_emnist_cnn(0), jpm.EMNIST_FREEZE)
    return y


@pytest.fixture(scope="module")
def layouts(emnist_y):
    return (jflat.FlatLayout.of(emnist_y),
            tflat.FlatLayout.of(bridge.from_numpy_tree(emnist_y, "cpu")))


def _rows(layout, k, case, seed=0):
    """(k, size) flat rows with zero padding, plus one edge case."""
    rng = np.random.default_rng(seed)
    mat = np.zeros((k, layout.size), np.float32)
    for off, n in zip(layout.offsets, layout.sizes):
        mat[:, off:off + n] = rng.normal(0, 1e-2, (k, n))
    if case == "zero_leaf":
        mat[0, layout.offsets[2]:layout.offsets[2] + layout.sizes[2]] = 0.0
    elif case == "nan":
        mat[1, layout.offsets[3] + 17] = np.nan
    elif case == "inf":
        mat[1, layout.offsets[5] + 3] = -np.inf
    elif case == "ties":   # leaf 0 (32 values) gets scale 1.0 and
        mat[:, 0] = 127.0    # x/s = k + 1/2: round half to even
        mat[:, 1:32] = np.arange(-15.5, 15.0)
    return mat


def test_layout_matches_jax(layouts):
    jl, tl = layouts
    assert tl.size == jl.size == 89_088
    assert tl.num_blocks == jl.num_blocks == 87
    assert (tl.sizes, tl.padded, tl.offsets, tl.shapes) == (
        jl.sizes, jl.padded, jl.offsets, jl.shapes)
    np.testing.assert_array_equal(tl.block_leaf(), jl.block_leaf())
    assert tl.block_leaf().dtype == np.int32


def test_flatten_unflatten_roundtrip(emnist_y, layouts):
    jl, tl = layouts
    ty = bridge.from_numpy_tree(emnist_y, "cpu")
    vec = tl.flatten(ty)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jl.flatten(emnist_y)))
    back = tl.unflatten(vec)
    for (pa, a), (pb, b) in zip(tbasic.flatten_params(back),
                                tbasic.flatten_params(ty)):
        assert pa == pb and torch.equal(a, b)
    assert tl.unflatten(vec, dtype=torch.float64)["gn"]["scale"].dtype == \
        torch.float64


@pytest.mark.interpret
@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
def test_leaf_maxabs_and_qdq_match_pallas_bitwise(layouts, case):
    jl, tl = layouts
    mat = _rows(jl, 2, case)
    bl, L = jl.block_leaf(), len(jl.sizes)
    got_m = tref.leaf_maxabs_ref(torch.from_numpy(mat), bl, L).numpy()
    got_q = tref.fake_quantize_flat_ref(torch.from_numpy(mat), bl,
                                        n_leaves=L).numpy()
    for r in range(mat.shape[0]):
        x = jnp.asarray(mat[r])
        want_m = jq.leaf_maxabs(x, bl, L, interpret=True)
        want_q = jq.fake_quantize_flat(x, bl, L, interpret=True)
        assert same_bits(got_m[r], want_m), (case, r)
        assert same_bits(got_q[r], want_q), (case, r)
    # and the JAX package's own CPU reference agrees with both
    assert same_bits(got_q, jax.device_get(
        jflat.fake_quantize(jnp.asarray(mat), jl, 8)))


@pytest.mark.interpret
@pytest.mark.parametrize("n", [89_088, 5000, 1])
def test_sumsq_matches_pallas(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    want = float(jdp.sumsq(jnp.asarray(x), interpret=True))
    got = tflat.sumsq(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.ndim == 0
    # both float32 sums, reduced in different orders
    assert float(got) == pytest.approx(want, rel=1e-5)
    assert float(got) == pytest.approx(float((x.astype(np.float64) ** 2).sum()),
                                       rel=1e-5)


def test_cpu_wrappers_run_plain_versions_without_launching(layouts):
    _, tl = layouts
    kernels.reset_launches()
    x = torch.from_numpy(_rows(tl, 3, "random"))
    bl, L = tl.block_leaf(), len(tl.sizes)
    assert torch.equal(tq.leaf_maxabs(x, bl, L), tref.leaf_maxabs_ref(x, bl, L))
    assert torch.equal(tq.fake_quantize_flat(x, bl, L),
                       tref.fake_quantize_flat_ref(x, bl, n_leaves=L))
    assert torch.equal(tdp.sumsq(x[0]), tref.flat_sumsq_ref(x[0]))
    assert kernels.LAUNCHES == {name: 0 for name in kernels.LAUNCHES}


def test_wrappers_refuse_other_devices():
    x = torch.empty((1024,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tdp.sumsq(x)
    with pytest.raises(ValueError, match="CUDA"):
        tq.fake_quantize_flat(x, np.zeros(1, np.int32), 1)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_leaf_bitwise(bits):
    x = np.random.default_rng(bits).normal(size=(37, 5)).astype(np.float32)
    jqv, js = jcompress.quantize_leaf(jnp.asarray(x), bits)
    tqv, ts = tcompress.quantize_leaf(torch.from_numpy(x), bits)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    assert same_bits(ts.numpy(), np.asarray(js))
    tree = {"a": x, "b": {"c": x[:3] * 1e-3, "z": np.zeros((4,), np.float32)}}
    want = jcompress.fake_quantize_tree(jax.tree_util.tree_map(jnp.asarray,
                                                               tree), bits)
    got = tcompress.fake_quantize_tree(bridge.from_numpy_tree(tree, "cpu"),
                                       bits)
    for (pa, a), (pb, b) in zip(tbasic.flatten_params(got),
                                tbasic.flatten_params(want)):
        assert pa == pb and same_bits(a.numpy(), np.asarray(b))
    assert tcompress.quantized_uplink_bytes(got, bits) == \
        jcompress.quantized_uplink_bytes(want, bits)


def test_flat_fake_quantize_equals_tree_path(emnist_y, layouts):
    _, tl = layouts
    rng = np.random.default_rng(5)
    tree = tbasic.tree_map(
        lambda a: torch.from_numpy(rng.normal(size=a.shape).astype(np.float32)),
        bridge.from_numpy_tree(emnist_y, "cpu"))
    flat_q = tflat.fake_quantize(tl.flatten(tree), tl, 8)
    tree_q = tl.flatten(tcompress.fake_quantize_tree(tree, 8))
    # equal in value, exactly; not in bits: the tree path's int8 codes
    # turn a -0.0 into +0.0, as they do in the JAX package
    np.testing.assert_array_equal(flat_q.numpy(), tree_q.numpy())


@pytest.mark.parametrize("bits,clip,uniform", [(0, 0.0, False),
                                               (8, 0.0, False),
                                               (8, 0.05, True),
                                               (0, 0.05, True)])
def test_staged_tail_matches_jax(layouts, bits, clip, uniform):
    jl, _ = layouts
    mat = _rows(jl, 4, "random", seed=3)
    w = np.array([50.0, 20.0, 0.0, 35.0], np.float32)
    kw = dict(block_leaf=jl.block_leaf(), n_leaves=len(jl.sizes),
              align=jl.align, bits=bits, clip_norm=clip, uniform=uniform,
              wsum_fixed=4.0 if clip else None)
    want, winfo = jops.agg_tail(jnp.asarray(mat), jnp.asarray(w), **kw)
    got, ginfo = tops.agg_tail(torch.from_numpy(mat), torch.from_numpy(w),
                               **kw)
    assert ginfo["route"] == winfo["route"] == "staged"
    # the quantized operand is bitwise equal; the mean is a float32
    # matmul (and the clip a float32 norm) reduced in another order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)
    if clip:
        np.testing.assert_allclose(ginfo["update_norms"].numpy(),
                                   np.asarray(winfo["update_norms"]),
                                   rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(block_denom=True),
                                dict(remask_rows=True),
                                dict(block_denom=True, bits=8, threshold=0),
                                dict(remask_rows=True, threshold=0),
                                dict(block_denom=True, sigma=0.1),
                                dict(remask_rows=True, block_denom=True,
                                     screen=True)])
def test_tail_raises_for_later_slices(emnist_y, layouts, kw):
    """The trainability-tier arguments, which both routes refused before
    tiers were ported, against the JAX tail on the EMNIST layout: each
    row's block mask from the three-tier plan of
    ``examples/async_heterogeneous.py`` (tiers 1, 2, 1, 0; the full row at
    weight 0, so that conv2 has no weight). Rows carry
    values outside their tier where ``remask_rows`` must zero them, and
    exact zeros there otherwise (what the tiered client steps send). The
    update within rtol 1e-5 plus 4 ulps of max|update| (a float32 matmul
    and, with ``block_denom``, its per-block denominator, reduced in
    another order; the noise is the same draw within ulps), the route and
    the screen's masks equal. At the fused threshold's size the default
    route is fused and equals the staged route bit for bit."""
    from repro.core import plan as jplan
    from repro.core import sanitize as jsan
    from repro_torch.core import sanitize as tsan
    from repro_torch.nn import threefry
    jl, _ = layouts
    bm = jplan.compile_plan({"full": (), "mid": (r"^conv2/",),
                             "lite": (r"^conv1/", r"^conv2/")},
                            emnist_y).block_masks()[[1, 2, 1, 0]]
    mat = _rows(jl, 4, "random", seed=11)
    if not kw.get("remask_rows"):
        mat = (mat.reshape(4, -1, jl.align) * bm[:, :, None]).reshape(4, -1)
    w = np.array([50.0, 20.0, 35.0, 0.0], np.float32)
    kw = dict(kw)
    screen = kw.pop("screen", None)
    base = dict(block_leaf=jl.block_leaf(), n_leaves=len(jl.sizes),
                align=jl.align, **kw)
    want, winfo = jops.agg_tail(
        jnp.asarray(mat), jnp.asarray(w), bmask=jnp.asarray(bm),
        rng=jax.random.key(4) if kw.get("sigma") else None,
        screen=jsan.SanitizeConfig() if screen else None, **base)
    got, ginfo = tops.agg_tail(
        torch.from_numpy(mat), torch.from_numpy(w), bmask=torch.from_numpy(bm),
        rng=threefry.key(4) if kw.get("sigma") else None,
        screen=tsan.SanitizeConfig() if screen else None, **base)
    assert ginfo["route"] == winfo["route"].replace("/jit/", "/torch/")
    assert ginfo["route"] == ("fused/torch/exact" if "threshold" in kw
                              else "staged")
    want = np.asarray(want)
    tol = 1e-5 * np.abs(want) + 4 * np.spacing(np.abs(want).max())
    assert (np.abs(got.numpy() - want) <= tol).all()
    if screen:
        for key in ("nonfinite", "outlier"):
            assert np.array_equal(ginfo[key].numpy(), np.asarray(winfo[key]))
    # blocks no row trains keep delta 0 under the per-block denominator
    if kw.get("block_denom") and not kw.get("sigma"):
        dead = np.repeat((w[:, None] * bm).sum(0) == 0, jl.align)
        assert dead.any() and not got.numpy()[dead].any()
    nb = tops.AGG_FUSE_THRESHOLD // 1024 // 2
    big = torch.randn((2, nb * 1024),
                      generator=torch.Generator().manual_seed(0))
    bmask = torch.ones((2, nb))
    bmask[1, nb // 2:] = 0.0
    big[1, nb // 2 * 1024:] = 0.0
    args = dict(block_leaf=np.zeros(nb, np.int32), n_leaves=1, bits=8,
                bmask=bmask, block_denom=True)
    fused, finfo = tops.agg_tail(big, torch.ones(2), **args)
    staged, sinfo = tops.agg_tail(big, torch.ones(2), threshold=1 << 60,
                                  **args)
    assert (finfo["route"], sinfo["route"]) == ("fused/torch/exact", "staged")
    assert same_bits(fused.numpy(), staged.numpy())
