"""The port's plain seed reconstruction (``repro_torch/kernels/ref.py``)
against the Pallas kernel of ``repro/kernels/seed_reconstruct.py`` run in
interpret mode.

The squirrel3 words are integer math and must match the reference's hash
bit for bit. The Gaussians are Box-Muller over those exact uniforms, so
they differ only by how torch's and XLA's CPU ``log`` and ``cos`` round:
each is within 2 ulps of the exact value in both libraries, the sqrt
halves the log's share, and the two multiplies add one rounding each, so
float32 values agree within ULPS = 8 (measured: at most 4), bf16 values
within one bf16 ulp (a float32 difference can cross a rounding boundary).
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp

from repro.kernels import seed_reconstruct as jsr
from repro_torch.kernels import ops, ref
from repro_torch.kernels import seed_reconstruct as tsr

ULPS = 8
CASES = [(0, 0), (42, 7), (-3, 12345), (2**31 - 1, 3)]
SHAPES = [(300, 200), (7, 130), (1000,), (64, 64, 3)]


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _jax_bits(seed, leaf_id, rows, cols):
    """The reference kernel's own hash (``_squirrel3``) of every element."""
    r = jnp.arange(rows, dtype=jnp.int32)[:, None]
    c = jnp.arange(cols, dtype=jnp.int32)[None, :]
    idx = (r * cols + c).astype(jnp.uint32)
    seeds = jnp.asarray([seed, leaf_id * 40503], jnp.int32)
    sw = seeds[0].astype(jnp.uint32) * jnp.uint32(0x9E3779B9) + \
        seeds[1].astype(jnp.uint32)
    return (np.asarray(jsr._squirrel3(idx * jnp.uint32(2), sw)),
            np.asarray(jsr._squirrel3(idx * jnp.uint32(2) + jnp.uint32(1), sw)))


@pytest.mark.parametrize("seed,leaf_id", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_match_the_reference_hash(shape, seed, leaf_id):
    rows, cols = ref.seed_dims(shape)
    want1, want2 = _jax_bits(seed, leaf_id, rows, cols)
    got1, got2 = ref.seed_bits_plain(seed, leaf_id, rows, cols)
    np.testing.assert_array_equal(got1.numpy(), want1.astype(np.int64))
    np.testing.assert_array_equal(got2.numpy(), want2.astype(np.int64))
    # the wrapper's CPU path is the plain version
    w1, w2 = tsr.seed_bits(seed, leaf_id, shape, device="cpu")
    assert torch.equal(w1, got1) and torch.equal(w2, got2)


@pytest.mark.parametrize("seed,leaf_id", CASES)
@pytest.mark.parametrize("shape", SHAPES)
def test_gaussians_match_the_pallas_kernel(shape, seed, leaf_id):
    want = np.asarray(jsr.seed_reconstruct(seed, leaf_id, shape, 0.05,
                                           interpret=True))
    got = ops.seed_reconstruct(seed, leaf_id, shape, 0.05, device="cpu")
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert _ulps(got.numpy(), want) <= ULPS


def test_bf16_within_one_ulp_of_the_pallas_kernel():
    want = np.asarray(jsr.seed_reconstruct(5, 1, (256, 300), 0.02,
                                           dtype=jnp.bfloat16,
                                           interpret=True)).astype(np.float32)
    got = ops.seed_reconstruct(5, 1, (256, 300), 0.02, dtype=torch.bfloat16,
                               device="cpu")
    assert got.dtype == torch.bfloat16
    assert _ulps(got.float().numpy(), want) >> 16 <= 1


@pytest.mark.parametrize("block_rows", [1, 8, 64, 256, 1000])
def test_invariant_to_block_rows(block_rows):
    base = ref.seed_reconstruct_plain(42, 7, (300, 200), 0.05)
    got = ref.seed_reconstruct_plain(42, 7, (300, 200), 0.05,
                                     block_rows=block_rows)
    assert torch.equal(got, base)
    # and the reference kernel's own tiling
    want = np.asarray(jsr.seed_reconstruct(42, 7, (300, 200), 0.05,
                                           block_rows=64, interpret=True))
    assert _ulps(got.numpy(), want) <= ULPS


def test_seeds_and_leaves_draw_different_tensors():
    a = ref.seed_reconstruct_plain(42, 7, (64, 64), 1.0)
    assert not torch.equal(a, ref.seed_reconstruct_plain(43, 7, (64, 64), 1.0))
    assert not torch.equal(a, ref.seed_reconstruct_plain(42, 8, (64, 64), 1.0))
    x = ref.seed_reconstruct_plain(1, 2, (512, 512), 0.5).double()
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 0.5) < 0.01


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    n = rng.integers(0, 2**32, 10_000, dtype=np.uint64).astype(np.uint32)
    for c in (0xB5297A4D, 0x1B56C4E9, 0xFFFFFFFF, 1):
        want = (n * np.uint32(c)).astype(np.int64)
        got = ref._mul32(torch.from_numpy(n.astype(np.int64)), c)
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.seed_reconstruct(0, 0, (4, 4), 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsr.seed_bits(0, 0, (4, 4))
