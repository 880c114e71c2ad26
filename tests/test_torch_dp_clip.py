"""The DP clip of the port (``kernels/dp_clip.clip_flat`` over rows,
``clip_accumulate``; ``core/flat.clip`` / ``pad_rows``, ``fedpt.clip_delta``)
against the JAX package, on the CPU, where the wrappers run their plain
versions (``kernels/ref.py``).

Tolerances:
* the plain row clip against JAX's ``ref.flat_clip_ref`` row by row: the
  per-block sums of squares are the same float32 operations in the same
  order; the two combine a row's blocks in torch's and XLA's orders, so
  the norms agree within 2 * blocks * 2**-24 relative (each float32 sum
  of m non-negative terms is within (m - 1) * 2**-24 of the exact one)
  and the clipped values within that plus three roundings (division,
  min, product); a row under the clip (scale exactly 1), a zero row, a
  NaN row and an Inf row bit for bit;
* against the Pallas kernels in interpret mode (``block=4096``, as
  ``tests/test_kernels.py`` runs them), whose norm sums 4096-element
  tiles in sequence: rtol 1e-6 on the norms, and on the values relative
  to the terms they add.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.core import fedpt as jfedpt
from repro.core import flat as jflat
from repro.kernels import dp_clip as jdp
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import flat as tflat
from repro_torch.kernels import dp_clip as tdp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

U = 2.0 ** -24
CLIP = 0.5


def same_bits(a, b) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return False
    keep = ~np.isnan(a)
    return np.array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


def clip_rows(n, seed=0):
    """Six rows: clipped, zero, under the clip, a NaN, an Inf, clipped."""
    g = np.random.default_rng(seed)
    m = (g.normal(size=(6, n)) * 1e-2).astype(np.float32)
    m[1] = 0.0
    m[2] *= np.float32(0.5 * CLIP / np.linalg.norm(m[2].astype(np.float64)))
    m[3, n // 3] = np.nan
    m[4, n // 2] = np.inf
    m[5] *= np.float32(40.0)
    return m


@pytest.mark.parametrize("n", [3 * 1024, 89_088, 89_088 + 512, 1000])
def test_row_clip_matches_jax_ref_row_by_row(n):
    m = clip_rows(n, seed=n)
    got, gnorm = tref.flat_clip_ref(torch.from_numpy(m), CLIP)
    nb = -(-n // 1024)
    rtol = 2 * nb * U
    for r in range(m.shape[0]):
        want, wnorm = jref.flat_clip_ref(jnp.asarray(m[r]), CLIP)
        want, wnorm = np.asarray(want), np.asarray(wnorm)
        if r in (0, 5):
            assert float(gnorm[r]) == pytest.approx(float(wnorm), rel=rtol)
            np.testing.assert_allclose(got[r].numpy(), want,
                                       rtol=rtol + 3 * U, atol=0)
        else:
            assert same_bits(gnorm[r], wnorm), r
            assert same_bits(got[r].numpy(), want), r
    assert same_bits(got[2].numpy(), m[2]) and np.isnan(got[3].numpy()).all()
    assert float(gnorm[1]) == 0.0 and not got[1].numpy().any()
    # a 1-D vector is one row; the same bits on a second run
    one, onorm = tref.flat_clip_ref(torch.from_numpy(m[0]), CLIP)
    assert same_bits(one.numpy(), got[0].numpy()) and same_bits(onorm,
                                                                 gnorm[0])
    again, anorm = tref.flat_clip_ref(torch.from_numpy(m), CLIP)
    assert same_bits(again.numpy(), got.numpy())
    assert same_bits(anorm.numpy(), gnorm.numpy())


@pytest.mark.interpret
@pytest.mark.parametrize("n,clip", [(1000, 0.5), (32768, 3.0),
                                    (89_088, 0.5), (100_001, 1.0)])
def test_row_clip_matches_pallas_interpret(n, clip):
    g = np.random.default_rng(n)
    m = (g.normal(size=(3, n)) * np.array([[2.0], [1e-4], [0.05]])
         ).astype(np.float32)
    got, gnorm = tdp.clip_flat(torch.from_numpy(m), clip)
    for r in range(3):
        want, wnorm = jdp.clip_flat(jnp.asarray(m[r]), clip, block=4096,
                                    interpret=True)
        assert float(gnorm[r]) == pytest.approx(float(wnorm), rel=1e-6)
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want),
                                   rtol=1e-6 + 3 * U, atol=0)


@pytest.mark.interpret
@pytest.mark.parametrize("n,clip", [(1000, 0.5), (32768, 3.0),
                                    (100_001, 1.0), (5, 10.0)])
def test_clip_accumulate_matches_pallas_and_ref(n, clip):
    g = np.random.default_rng(n)
    x = (g.normal(size=n) * 2.0).astype(np.float32)
    acc = np.linspace(0, 1, n, dtype=np.float32)
    kernels.reset_launches()
    got, gnorm = tops.clip_accumulate(torch.from_numpy(acc),
                                      torch.from_numpy(x), clip)
    assert kernels.LAUNCHES["clip_accumulate"] == 0   # the CPU: plain
    scale = min(1.0, clip / float(np.linalg.norm(x.astype(np.float64))))
    terms = np.abs(acc) + np.abs(x) * scale
    for want, wnorm in (
            jdp.clip_accumulate(jnp.asarray(acc), jnp.asarray(x), clip,
                                block=4096, interpret=True),
            jref.dp_clip_accumulate_ref(jnp.asarray(acc), jnp.asarray(x),
                                        clip)):
        assert float(gnorm) == pytest.approx(float(wnorm), rel=1e-6)
        assert (np.abs(got.numpy() - np.asarray(want))
                <= 1e-6 * terms).all()
    # under the clip the scale is exactly 1: acc + x bit for bit
    small = x * np.float32(1e-6)
    out, _ = tdp.clip_accumulate(torch.from_numpy(acc),
                                 torch.from_numpy(small), clip)
    assert same_bits(out.numpy(), acc + small)
    xn = x.copy()
    xn[0] = np.nan
    out, nrm = tdp.clip_accumulate(torch.from_numpy(acc),
                                   torch.from_numpy(xn), clip)
    assert np.isnan(float(nrm)) and np.isnan(out.numpy()).all()


def test_flat_clip_routes_and_clip_delta_matches_jax():
    g = np.random.default_rng(3)
    tree = {"a": {"kernel": (g.normal(size=(40, 30)) * 0.1
                             ).astype(np.float32)},
            "b": (g.normal(size=(7,))).astype(np.float32)}
    ttree = {"a": {"kernel": torch.from_numpy(tree["a"]["kernel"])},
             "b": torch.from_numpy(tree["b"])}
    kernels.reset_launches()
    layout = tflat.FlatLayout.of(ttree)
    rtol = 2 * layout.num_blocks * U
    got, gnorm = tfedpt.clip_delta(ttree, CLIP)
    want, wnorm = jfedpt.clip_delta(jax.tree_util.tree_map(jnp.asarray, tree),
                                    CLIP)
    assert float(gnorm) == pytest.approx(float(wnorm), rel=rtol)
    np.testing.assert_allclose(got["a"]["kernel"].numpy(),
                               np.asarray(want["a"]["kernel"]),
                               rtol=rtol + 3 * U, atol=0)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]),
                               rtol=rtol + 3 * U, atol=0)
    vec = layout.flatten(ttree)
    for x in (vec, torch.stack([vec, vec * 1e-3])):
        c, n = tflat.clip(x, CLIP, layout)
        rc, rn = tops.flat_clip(x, CLIP)
        assert torch.equal(c, rc) and torch.equal(n, rn)
    flat1, n1 = tfedpt.clip_delta(vec, CLIP)
    assert torch.equal(flat1, tflat.clip(vec, CLIP)[0])
    assert sum(kernels.LAUNCHES.values()) == 0


def test_pad_rows_matches_jax():
    m = np.arange(12, dtype=np.float32).reshape(2, 6)
    for rows in (2, 5):
        got = tflat.pad_rows(torch.from_numpy(m), rows)
        want = jflat.pad_rows(jnp.asarray(m), rows)
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tflat.pad_rows(torch.from_numpy(m), 1)


def test_clip_wrappers_refuse_other_devices():
    meta = torch.empty((2, 2048), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tdp.clip_flat(meta, CLIP)
    with pytest.raises(ValueError, match="CUDA"):
        tdp.clip_accumulate(meta[0], meta[1], CLIP)
    with pytest.raises(ValueError, match="CUDA"):
        tflat.clip(meta, CLIP)
