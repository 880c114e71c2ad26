"""The port's fused aggregation tail, DP noise and quarantine screen
against the JAX package, on the CPU.

Inputs are numpy arrays from a seed, fed to both packages: 5 client rows
over a ragged 4-leaf map of 7 blocks of 1024. The JAX side runs the
Pallas kernels with ``interpret=True`` and its own plain oracles; the
port runs the plain versions its wrappers take for CPU tensors (the CUDA
kernels are held against those on the card, in
``tests/test_torch_kernels_cuda.py``). Tolerances:

* block max-abs, scales and int8 codes (on finite rows): bit for bit;
* block sum of squares: bit for bit against the JAX oracle (the same
  log-halving order), within 8 ulps of the interpreted Pallas kernel
  (``jnp.sum`` reduces in XLA's order; 6 measured);
* quantized row sum of squares: rtol 1e-6 (float sums over blocks in
  another order);
* ``apply_coeff``: 4 ulps of max|out|;
* noise: 4 ulps per element (the threefry port's normals; the sigma
  multiply is the same float32 rounding on both sides);
* the whole tail: quarantine masks equal, the update within rtol 1e-5
  plus 4 ulps of max|update| (float reassociation of the GEMV and the
  clip fold; on the coefficient route the coefficients carry the
  quantized sums' rtol 1e-6).
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.core import flat as jflat
from repro.core import sanitize as jsan
from repro.kernels import agg_tail as jat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import flat as tflat
from repro_torch.core import sanitize as tsan
from repro_torch.kernels import agg_tail as tat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.nn import threefry

BL = np.array([0, 1, 1, 1, 2, 2, 3], np.int32)
L, NB, BLOCK = 4, BL.size, 1024
SIZE = NB * BLOCK
K = 5
U = 2.0 ** -24
STAGED, FUSED = 1 << 60, 0
SCREEN = (10.0, 0.0)   # norm_mult of the JAX tests; 0 turns outliers off


def same_bits(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    keep = ~np.isnan(a)
    return np.array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


def ulps(a, b):
    """Per-element distance in units of the float32 spacing at |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float32)
    return np.abs(a - b) / np.spacing(np.abs(b)).astype(np.float64)


def make_mat(seed=0, k=K, nan_row=None, inf_row=None, outlier_row=None,
             ties=False):
    rng = np.random.default_rng(seed)
    mat = rng.normal(0, 0.5, (k, SIZE)).astype(np.float32)
    mat[:, BLOCK // 2:BLOCK] *= 1e-3      # leaf 0: a small half
    if nan_row is not None:
        mat[nan_row, 1500] = np.nan
    if inf_row is not None:
        mat[inf_row, SIZE // 2 + 1] = -np.inf
    if outlier_row is not None:
        mat[outlier_row] *= 1e6
    if ties:   # leaf 0 gets scale 1.0 and x/s = j + 1/2 (half to even)
        mat[:, :BLOCK] = 0.0
        mat[:, 0] = 127.0
        mat[:, 1:255] = np.arange(-126.5, 127.0)
    return mat


def make_weights(seed=1, k=K, zero=()):
    w = np.random.default_rng(seed).uniform(0.5, 2.0, (k,)).astype(np.float32)
    w[list(zero)] = 0.0
    return w


def t_(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the Pallas kernels


@pytest.mark.interpret
@pytest.mark.parametrize("case", ["random", "nan", "inf", "ties"])
def test_block_stats_match_pallas(case):
    mat = make_mat(seed=1, nan_row=2 if case == "nan" else None,
                   inf_row=0 if case == "inf" else None, ties=case == "ties")
    kernels.reset_launches()
    bmax, bsumsq = tat.block_stats(t_(mat))
    assert kernels.LAUNCHES["block_stats"] == 0      # CPU: plain version
    want_max, want_ss = jat.block_stats(jnp.asarray(mat), block=BLOCK,
                                        interpret=True)
    assert same_bits(bmax.numpy(), want_max)
    _, oracle_ss = jref.agg_block_stats_ref(jnp.asarray(mat), block=BLOCK,
                                            with_sumsq=True)
    assert same_bits(bsumsq.numpy(), oracle_ss)
    finite = np.isfinite(np.asarray(want_ss))
    assert np.array_equal(finite, np.isfinite(bsumsq.numpy()))
    assert ulps(bsumsq.numpy()[finite], np.asarray(want_ss)[finite]).max() <= 8
    if case == "nan":
        assert np.isnan(bmax[2, 1].item())
        assert not torch.isfinite(bmax).all(dim=-1)[2]


@pytest.mark.interpret
@pytest.mark.parametrize("case", ["random", "ties", "nan"])
def test_scales_and_pack_match_pallas(case):
    nan_row = 3 if case == "nan" else None
    mat = make_mat(seed=2, nan_row=nan_row, ties=case == "ties")
    bmax, _ = tat.block_stats(t_(mat))
    sblock = tref.agg_scales_ref(bmax, BL, 8, L)
    jbmax, _ = jref.agg_block_stats_ref(jnp.asarray(mat), block=BLOCK)
    jsblock = jref.agg_scales_ref(jbmax, BL, 8, L)
    assert same_bits(sblock.numpy(), jsblock)
    q, qss = tat.pack(t_(mat), sblock)
    jq, jqss = jat.pack(jnp.asarray(mat), jsblock, bits=8, block=BLOCK,
                        interpret=True)
    assert q.dtype == torch.int8 and q.shape == (K, NB, BLOCK)
    rows = [r for r in range(K) if r != nan_row]   # a NaN's code is unset
    assert np.array_equal(q.numpy()[rows], np.asarray(jq)[rows])
    np.testing.assert_allclose(qss.numpy()[rows], np.asarray(jqss)[rows],
                               rtol=1e-6)
    if case == "ties":
        assert np.array_equal(q.numpy()[0, 0, 1:255],
                              np.round(np.arange(-126.5, 127.0)))
    # dequantized codes are the staged Q->DQ, exactly (in value: an int8
    # code has no -0, where the staged Q->DQ keeps a -0.0)
    dq = (q.float() * sblock[..., None]).reshape(K, SIZE)
    qdq = tref.fake_quantize_flat_ref(t_(mat), BL, n_leaves=L)
    assert np.array_equal(dq.numpy()[rows], qdq.numpy()[rows])


@pytest.mark.interpret
@pytest.mark.parametrize("with_noise", [False, True])
def test_apply_coeff_matches_pallas(with_noise):
    mat = make_mat(seed=3)
    bmax, _ = tat.block_stats(t_(mat))
    sblock = tref.agg_scales_ref(bmax, BL, 8, L)
    q, _ = tat.pack(t_(mat), sblock)
    w = np.linspace(0.2, 1.4, K).astype(np.float32)
    coeff = (t_(w) / t_(w).sum())[:, None] * sblock
    noise = (np.random.default_rng(9).normal(0, 0.01, SIZE).astype(np.float32)
             if with_noise else None)
    got = tat.apply_coeff(q, coeff, None if noise is None else t_(noise))
    want = jat.apply_coeff(jnp.asarray(q.numpy()), jnp.asarray(coeff.numpy()),
                           jnp.asarray(noise if with_noise
                                       else np.zeros(SIZE, np.float32)),
                           block=BLOCK, interpret=True)
    want = np.asarray(want)
    scale = np.spacing(np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= 4 * scale
    # and the JAX oracle of the same order (XLA may contract its
    # multiply-adds into FMAs): the same bound
    oracle = jref.agg_apply_ref(jnp.asarray(q.numpy()),
                                jnp.asarray(coeff.numpy()),
                                noise=None if noise is None
                                else jnp.asarray(noise), block=BLOCK)
    assert np.abs(got.numpy() - np.asarray(oracle)).max() <= 4 * scale


def test_apply_exact_matches_jax():
    """Each output element is a K-length float32 dot over w_k * (q_k * s),
    then a division by the float32 sum of the weights. Summed in another
    order, a package's dot lies within K * 2**-24 * S of the exact one,
    S = sum_k |w_k * q_k * s| (taken in float64), and the final scale
    (the weights' sum, within (K - 1) * 2**-24, and the division, one
    rounding) within K * 2**-24 of the result: the two packages within
    twice that. The bound is relative to S, not to the result, which
    cancellation can bring near zero."""
    mat = make_mat(seed=4)
    bmax, _ = tat.block_stats(t_(mat))
    sblock = tref.agg_scales_ref(bmax, BL, 8, L)
    q, _ = tat.pack(t_(mat), sblock)
    w = make_weights()
    got = tref.agg_apply_exact_ref(q, t_(w), sblock=sblock, wsum=t_(w).sum(),
                                   cols=3)
    want = np.asarray(jref.agg_apply_exact_ref(
        jnp.asarray(q.numpy()), jnp.asarray(w),
        sblock=jnp.asarray(sblock.numpy()), wsum=jnp.sum(w), cols=3))
    x = (q.numpy().astype(np.float64)
         * sblock.numpy().astype(np.float64)[:, :, None]).reshape(K, -1)
    terms = np.abs(w.astype(np.float64)[:, None] * x).sum(0)
    wsum = float(w.astype(np.float64).sum())
    bound = 2 * K * U * (terms / wsum + np.abs(want))
    assert np.all(np.abs(got.numpy() - want) <= bound)
    # chunking along columns never reorders the K-length dots
    whole = tref.agg_apply_exact_ref(q, t_(w), sblock=sblock,
                                     wsum=t_(w).sum(), cols=NB)
    assert same_bits(got.numpy(), whole.numpy())


@pytest.mark.parametrize("clip_norm", [0.5, 1e6])
def test_flat_clip_matches_jax(clip_norm):
    x = np.random.default_rng(6).normal(0, 0.1, SIZE).astype(np.float32)
    got, gnrm = tref.flat_clip_ref(t_(x), clip_norm)
    want, wnrm = jref.flat_clip_ref(jnp.asarray(x), clip_norm)
    assert float(gnrm) == pytest.approx(float(wnrm), rel=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=0)
    if clip_norm > float(gnrm):
        assert same_bits(got.numpy(), x)


# ---------------------------------------------------------------------------
# DP noise and the quarantine screen


def test_draw_noise_contract_and_jax():
    v = t_(np.random.default_rng(0).normal(size=SIZE).astype(np.float32))
    for seed, sigma in ((0, 0.25), (7, 0.4 * 0.5 / 10)):
        noise = tflat.draw_noise(threefry.key(seed), SIZE, sigma)
        assert noise.dtype == torch.float32 and noise.shape == (SIZE,)
        assert torch.equal(tflat.add_noise(v, sigma, threefry.key(seed)),
                           v + noise)
        want = np.asarray(jflat.draw_noise(jax.random.key(seed), SIZE, sigma))
        assert ulps(noise.numpy(), want).max() <= 4
        assert abs(float(noise.std()) / sigma - 1) < 0.05


def test_nanmedian_is_jax_midpoint():
    """jnp.nanmedian takes the midpoint of the two middle values for an
    even count; torch.nanmedian takes the lower one."""
    rng = np.random.default_rng(5)
    cases = [[1, 2, 4, 8], [1, 2, 4], [np.nan] * 3, [np.nan, 3, 1, 2, 7],
             rng.lognormal(size=10), rng.lognormal(size=9)]
    for x in cases:
        x = np.asarray(x, np.float32)
        assert same_bits(tsan.nanmedian(t_(x)).numpy(),
                         jnp.nanmedian(jnp.asarray(x))), x
    assert float(tsan.nanmedian(t_(np.float32([1, 2, 4, 8])))) == 3.0
    assert float(torch.nanmedian(t_(np.float32([1, 2, 4, 8])))) == 2.0


def test_screen_outlier_threshold_on_even_live_count():
    """Four live rows of norms 1, 2, 4, 8 and norm_mult 1.8: the midpoint
    median 3 quarantines only the 8 (threshold 5.4); the lower median 2
    would quarantine the 4 too (threshold 3.6)."""
    mat = np.zeros((4, SIZE), np.float32)
    mat[:, 0] = [1.0, 2.0, 4.0, 8.0]
    w = np.ones(4, np.float32)
    cfg_j = jsan.SanitizeConfig(norm_mult=1.8)
    cfg_t = tsan.SanitizeConfig(norm_mult=1.8)
    _, jw, jinfo = jsan.screen_rows(jnp.asarray(mat), jnp.asarray(w), cfg_j)
    _, tw, tinfo = tsan.screen_rows(t_(mat), t_(w), cfg_t)
    assert np.array_equal(tinfo["outlier"].numpy(), np.asarray(jinfo["outlier"]))
    assert tinfo["outlier"].tolist() == [False, False, False, True]
    assert np.array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("norm_mult", SCREEN)
def test_screen_rows_and_from_stats_match_jax(norm_mult):
    mat = make_mat(seed=13, nan_row=0, inf_row=3, outlier_row=4)
    w = make_weights(zero=(1,))
    jcfg = jsan.SanitizeConfig(nonfinite=True, norm_mult=norm_mult)
    tcfg = tsan.SanitizeConfig(nonfinite=True, norm_mult=norm_mult)
    jclean, jw, jinfo = jsan.screen_rows(jnp.asarray(mat), jnp.asarray(w),
                                         jcfg, BLOCK)
    tclean, tw, tinfo = tsan.screen_rows(t_(mat), t_(w), tcfg, BLOCK)
    for key in ("nonfinite", "outlier"):
        assert np.array_equal(tinfo[key].numpy(), np.asarray(jinfo[key]))
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert same_bits(tclean.numpy(), jclean)
    np.testing.assert_allclose(tinfo["norms"].numpy(),
                               np.asarray(jinfo["norms"]), rtol=1e-6)
    # within the port: the fused screen's stats decide the same, bit for bit
    bmax, bsumsq = tat.block_stats(t_(mat))
    raw = torch.sqrt(tref._row_combine(bsumsq))
    sw, q, sinfo = tsan.screen_from_stats(raw, torch.isfinite(bmax).all(-1),
                                          t_(w), tcfg)
    assert torch.equal(sw, tw)
    assert torch.equal(q, tinfo["nonfinite"] | tinfo["outlier"])
    assert same_bits(sinfo["norms"].numpy(), tinfo["norms"].numpy())


def test_resolve_sanitize_matches_jax():
    for spec in (None, False, True, "on", "off", {"norm_mult": 3.0},
                 {"nonfinite": False, "norm_mult": 0.0}):
        want = jsan.resolve_sanitize(spec)
        got = tsan.resolve_sanitize(spec)
        assert (got is None) == (want is None), spec
        if got is not None:
            assert (got.nonfinite, got.norm_mult) == (want.nonfinite,
                                                      want.norm_mult)
    with pytest.raises(ValueError):
        tsan.resolve_sanitize("sometimes")
    with pytest.raises(TypeError):
        tsan.resolve_sanitize(3)


# ---------------------------------------------------------------------------
# the whole tail: the port's compose against JAX's, and within the port


PIPELINES = {
    "quant": dict(bits=8),
    "quant_clip": dict(bits=8, clip_norm=0.5, uniform=True, wsum_fixed=5.0),
    "quant_noise": dict(bits=8, wsum_fixed=5.0, sigma=0.02),
    "quant_dp": dict(bits=8, clip_norm=0.5, uniform=True, wsum_fixed=5.0,
                     sigma=0.02),
    "clip": dict(clip_norm=0.5, uniform=True, wsum_fixed=5.0),
    "noise": dict(wsum_fixed=5.0, sigma=0.02),
}


def _run(pkg, mat, w, seed, screen, **kw):
    kw = dict(kw, block_leaf=BL, n_leaves=L, align=BLOCK)
    if pkg == "jax":
        cfg = None if screen is None else jsan.SanitizeConfig(norm_mult=screen)
        rng = jax.random.key(seed) if kw.get("sigma") else None
        out, info = jat.compose(jnp.asarray(mat), jnp.asarray(w), rng=rng,
                                screen=cfg, engine="ref", **kw)
        return np.asarray(out), {k: np.asarray(v) for k, v in info.items()
                                 if k != "route"}, info["route"]
    cfg = None if screen is None else tsan.SanitizeConfig(norm_mult=screen)
    rng = threefry.key(seed) if kw.get("sigma") else None
    out, info = tops.agg_tail(t_(mat), t_(w), rng=rng, screen=cfg,
                              threshold=FUSED, **kw)
    return out.numpy(), {k: v.numpy() for k, v in info.items()
                         if k != "route"}, info["route"]


@pytest.mark.parametrize("screen", [None, 10.0])
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_compose_matches_jax(name, screen):
    kw = PIPELINES[name]
    # with the screen: a NaN row and an outlier row leave 4 live rows
    # (the outlier votes), an even count
    mat = make_mat(seed=21, nan_row=1 if screen else None,
                   outlier_row=3 if screen else None)
    w = make_weights()
    jout, jinfo, jroute = _run("jax", mat, w, 5, screen, **kw)
    tout, tinfo, troute = _run("torch", mat, w, 5, screen, **kw)
    kind = "coeff" if kw.get("bits") and (kw.get("clip_norm")
                                          or kw.get("sigma")) else "exact"
    assert jroute == f"fused/ref/{kind}" and troute == f"fused/torch/{kind}"
    assert sorted(tinfo) == sorted(jinfo)
    if screen:
        for key in ("nonfinite", "outlier"):
            assert np.array_equal(tinfo[key], jinfo[key]), key
        assert tinfo["nonfinite"].tolist() == [False, True, False, False,
                                               False]
        assert tinfo["outlier"].tolist() == [False, False, False, True,
                                             False]
        np.testing.assert_allclose(tinfo["norms"], jinfo["norms"], rtol=1e-6)
    if "update_norms" in jinfo:
        np.testing.assert_allclose(tinfo["update_norms"],
                                   jinfo["update_norms"], rtol=1e-6)
    assert np.isfinite(tout).all()
    tol = 1e-5 * np.abs(jout) + 4 * np.spacing(np.abs(jout).max())
    assert (np.abs(tout - jout) <= tol).all(), name


def test_fused_equals_staged_within_port():
    mat, w = make_mat(seed=31), make_weights(zero=(2,))
    kw = dict(block_leaf=BL, n_leaves=L, align=BLOCK)
    # quantize-only: the exact GEMV over the dequantized codes is the
    # staged mean, bit for bit
    for extra in (dict(bits=8), dict(bits=8, uniform=True), dict(bits=4)):
        staged, sinfo = tops.agg_tail(t_(mat), t_(w), threshold=STAGED,
                                      **kw, **extra)
        fused, finfo = tops.agg_tail(t_(mat), t_(w), threshold=FUSED,
                                     **kw, **extra)
        assert (sinfo["route"], finfo["route"]) == ("staged",
                                                    "fused/torch/exact")
        assert same_bits(staged.numpy(), fused.numpy()), extra
    # screen decisions: equal on both routes, whatever else the tail does
    poisoned = make_mat(seed=32, nan_row=0, inf_row=2, outlier_row=4)
    for extra in (dict(), dict(bits=8),
                  dict(bits=8, clip_norm=0.5, uniform=True, wsum_fixed=5.0,
                       sigma=0.01)):
        rng = threefry.key(1) if extra.get("sigma") else None
        cfg = tsan.SanitizeConfig()
        s_out, s_info = tops.agg_tail(t_(poisoned), t_(w), rng=rng,
                                      screen=cfg, threshold=STAGED,
                                      **kw, **extra)
        f_out, f_info = tops.agg_tail(t_(poisoned), t_(w), rng=rng,
                                      screen=cfg, threshold=FUSED,
                                      **kw, **extra)
        for key in ("nonfinite", "outlier"):
            assert torch.equal(s_info[key], f_info[key]), (extra, key)
        assert same_bits(s_info["norms"].numpy(), f_info["norms"].numpy())
        assert torch.isfinite(f_out).all() and torch.isfinite(s_out).all()
        torch.testing.assert_close(f_out, s_out, rtol=1e-4, atol=1e-5)


def test_dispatcher_routes_like_jax():
    small = np.zeros((2, SIZE), np.float32)
    w = np.ones(2, np.float32)
    kw = dict(block_leaf=BL, n_leaves=L)
    for extra in (dict(bits=8), dict(), dict(threshold=0),
                  dict(threshold=0, bits=8, clip_norm=0.1),
                  dict(threshold=2 * SIZE + 1, bits=8)):
        _, jinfo = jops.agg_tail(jnp.asarray(small), jnp.asarray(w), **kw,
                                 **extra)
        _, tinfo = tops.agg_tail(t_(small), t_(w), **kw, **extra)
        assert tinfo["route"] == jinfo["route"].replace("/jit/", "/torch/")
    # above the threshold a quantized buffer goes fused by default
    nb = tops.AGG_FUSE_THRESHOLD // BLOCK // 2
    big = torch.zeros((2, nb * BLOCK))
    _, info = tops.agg_tail(big, torch.ones(2), block_leaf=np.zeros(nb,
                                                                  np.int32),
                            n_leaves=1, bits=8)
    assert info["route"] == "fused/torch/exact"
    with pytest.raises(ValueError, match="rng"):
        tops.agg_tail(t_(small), t_(w), **kw, sigma=0.1)
    # the output hook is the flat plane of a mesh: a bare function is
    # refused, the plane of one rank holding the whole buffer is the
    # unmeshed tail
    with pytest.raises(TypeError, match="flat plane"):
        tat.compose(t_(small), t_(w), **kw, constrain_fn=lambda v: v)
    rows = np.random.default_rng(0).normal(size=(2, SIZE)).astype(np.float32)
    want, _ = tat.compose(t_(rows), t_(w), **kw, bits=8)
    got, _ = tat.compose(t_(rows), t_(w), **kw, bits=8,
                         constrain_fn=tflat.WHOLE)
    assert torch.equal(got, want)


def test_kernel_paths_refuse_other_devices():
    meta = torch.empty((2, SIZE), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tat.block_stats(meta)
    with pytest.raises(ValueError, match="CUDA"):
        tat.pack(meta, torch.empty((2, NB), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        tat.apply_coeff(torch.empty((2, NB, BLOCK), dtype=torch.int8,
                                    device="meta"),
                        torch.empty((2, NB), device="meta"))
    # the fused route sends any buffer not on the CPU to the kernels
    with pytest.raises(ValueError, match="CUDA"):
        tops.agg_tail(meta, torch.ones(2, device="meta"), block_leaf=BL,
                      n_leaves=L, bits=8, threshold=FUSED)


# ---------------------------------------------------------------------------
# The order of the card's stats and pack kernels (csrc/agg_tail.cu), in
# numpy: one warp per (row, block) tile, lane t holding the elements
# 4 t + 128 j + c. The emulations fix the order on the CPU, where a
# mistake in it would otherwise show only on the card.


def _shfl_down(y, off):
    """__shfl_down_sync over axis 0 (the 32 lanes): lane t reads lane
    t + off, and a lane whose source is past 31 reads its own value."""
    lanes = np.arange(32)
    return y[np.where(lanes + off < 32, lanes + off, lanes)]


def emulate_warp_sumsq(x):
    """The stats kernel's sum of squares of each row of x (T, W) float32,
    W a power of two in [64, 2048]: squares per register, the levels
    h >= 128 over a lane's rows j, h = 64 ... 4 by lane shuffles, h = 2
    and 1 within lane 0's four values."""
    T, W = x.shape
    rows, lanes = max(W // 128, 1), min(32, W // 4)
    v = np.zeros((32, T, rows, 4), np.float32)      # lane, tile, j, c
    v[:lanes] = x.reshape(T, rows, lanes, 4).transpose(2, 0, 1, 3)
    y = v * v
    n = rows
    while n > 1:
        y = y[:, :, :n // 2] + y[:, :, n // 2:n]
        n //= 2
    y = y[:, :, 0]                                   # lane, tile, c
    off = min(W, 128) // 8
    while off:
        y = y + _shfl_down(y, off)
        off //= 2
    y0 = y[0, :, 0] + y[0, :, 2]
    y1 = y[0, :, 1] + y[0, :, 3]
    return y0 + y1


@pytest.mark.parametrize("block", [64, 128, 256, 512, 1024, 2048])
def test_warp_sumsq_order_is_the_plain_halving_order(block):
    rng = np.random.default_rng(block)
    x = (rng.standard_normal((40, block)) * rng.uniform(
        1e-3, 1e3, (40, 1))).astype(np.float32)
    x[3, 7] = np.nan
    x[5, 1] = np.inf
    x[6] = 0.0
    want = tref._sumsq_blocks(torch.from_numpy(x)).numpy()
    got = emulate_warp_sumsq(x)
    assert same_bits(got, want)
    # a wrong lane order (say, lane t taking 32 contiguous elements) is
    # caught: sums of squares of random data are not associative
    wrong = emulate_warp_sumsq(np.ascontiguousarray(
        x.reshape(40, -1, 4).transpose(0, 2, 1).reshape(40, block)))
    assert not same_bits(wrong, want)


def emulate_row_combine(part, threads=256):
    """The card's row combine of (R, nb) float32 block sums: thread i sums
    blocks i, i + 256, ... in order, then a shuffle tree in each warp and
    one over the 8 warps' sums."""
    R, nb = part.shape
    acc = np.zeros((threads, R), np.float32)
    for b0 in range(0, nb, threads):
        chunk = part[:, b0:b0 + threads].T
        acc[:chunk.shape[0]] = acc[:chunk.shape[0]] + chunk
    warps = acc.reshape(threads // 32, 32, R)
    for off in (16, 8, 4, 2, 1):
        warps = np.stack([w + _shfl_down(w, off) for w in warps])
    lane = np.zeros((32, R), np.float32)
    lane[:threads // 32] = warps[:, 0]
    off = threads // 64
    while off:
        lane = lane + _shfl_down(lane, off)
        off //= 2
    return lane[0]


@pytest.mark.parametrize("nb", [1, 7, 255, 256, 257, 1656])
def test_row_combine_within_the_quantized_sum_bound(nb):
    """The card's combine order against the plain version's torch sum:
    both within (nb - 1) 2**-24 of the exact sum (positive terms), so
    within ``chip_smoke.qss_rtol(nb)`` = 2 nb 2**-24 of each other."""
    rng = np.random.default_rng(nb)
    part = (rng.uniform(0, 1, (10, nb)) * 10.0 ** rng.uniform(
        -6, 2, (10, nb))).astype(np.float32)
    got = emulate_row_combine(part)
    want = tref._row_combine(torch.from_numpy(part)).numpy()
    exact = part.astype(np.float64).sum(1)
    assert np.all(np.abs(got - exact) <= (nb - 1) * 2.0 ** -24 * exact)
    assert np.all(np.abs(got - want) <= 2 * nb * 2.0 ** -24 * want)
