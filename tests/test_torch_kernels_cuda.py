"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device (here
the kernels cannot even be built). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Imports neither JAX nor the JAX package. Max-abs and Q->DQ must match
bit for bit (NaN positions equal); sumsq within rtol 1e-5 of a float64
sum and with the same bits on every run.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import dp_clip, ops, quantize, ref

pytestmark = pytest.mark.cuda

EMNIST_BLOCK_LEAF = np.repeat(np.arange(8, dtype=np.int32),
                              [1, 1, 1, 50, 1, 31, 1, 1])


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def same_bits(a, b) -> bool:
    a, b = a.float().cpu(), b.float().cpu()
    if a.shape != b.shape or not torch.equal(a.isnan(), b.isnan()):
        return False
    keep = ~a.isnan()
    return torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))


def _mat(rows, block_leaf, seed=0, case="random"):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((rows, block_leaf.size * 1024), generator=g) * 1e-2
    if case == "zero_leaf":
        m[0, 2048:3072] = 0.0
    elif case == "nan":
        m[rows - 1, min(5000, m.shape[1] - 1)] = float("nan")
    elif case == "inf":
        m[0, 7] = float("-inf")
    elif case == "ties":   # leaf 0 gets scale 1.0 and x/s = k + 1/2
        m[:, :1024] = 0.0
        m[:, 0] = 127.0
        m[:, 1:255] = torch.arange(-126.5, 127.0)
    return m


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
@pytest.mark.parametrize("rows,block_leaf", [
    (10, EMNIST_BLOCK_LEAF),
    (3, np.array([0, 1, 1, 1, 2, 2, 3], np.int32)),
    (1, np.zeros(1, np.int32))])
def test_maxabs_and_qdq_match_plain_bitwise(dev, rows, block_leaf, case):
    m = _mat(rows, block_leaf, case=case).to(dev)
    L = int(block_leaf.max()) + 1
    assert same_bits(quantize.leaf_maxabs(m, block_leaf, L),
                     ref.leaf_maxabs_ref(m, block_leaf, L))
    got = quantize.fake_quantize_flat(m, block_leaf, L)
    assert same_bits(got, ref.fake_quantize_flat_ref(m, block_leaf,
                                                     n_leaves=L))
    assert same_bits(got.cpu(), ref.fake_quantize_flat_ref(
        m.cpu(), block_leaf, n_leaves=L))
    assert same_bits(quantize.fake_quantize_flat(m[0], block_leaf, L),
                     got[0])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_qdq_bits(dev, bits):
    m = _mat(4, EMNIST_BLOCK_LEAF, seed=bits).to(dev)
    assert same_bits(quantize.fake_quantize_flat(m, EMNIST_BLOCK_LEAF, 8,
                                                 bits=bits),
                     ref.fake_quantize_flat_ref(m, EMNIST_BLOCK_LEAF,
                                                bits=bits, n_leaves=8))


@pytest.mark.parametrize("n", [0, 1, 1023, 89_088, 89_088 + 77, 3_000_001])
def test_sumsq_matches_float64_and_is_deterministic(dev, n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(dev)
    got = dp_clip.sumsq(x)
    want = float((x.double() ** 2).sum())
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-30)
    assert torch.equal(got, dp_clip.sumsq(x))


def test_wrappers_count_launches_and_check_inputs(dev):
    kernels.reset_launches()
    x = _mat(2, EMNIST_BLOCK_LEAF).to(dev)
    dp_clip.sumsq(x[0].contiguous())
    quantize.fake_quantize_flat(x, EMNIST_BLOCK_LEAF, 8)
    assert kernels.LAUNCHES == {"sumsq": 1, "leaf_maxabs": 1,
                                "fake_quantize_flat": 1}
    with pytest.raises(TypeError):
        dp_clip.sumsq(x[0].double())
    with pytest.raises(ValueError):
        dp_clip.sumsq(x[:, ::2][0])     # not contiguous
    with pytest.raises(ValueError):
        quantize.leaf_maxabs(x[:, :1000].contiguous(), EMNIST_BLOCK_LEAF, 8)
    with pytest.raises(ValueError):
        quantize.leaf_maxabs(x, EMNIST_BLOCK_LEAF + 1, 8)


@pytest.mark.parametrize("bits,clip", [(0, 0.0), (8, 0.0), (8, 0.05)])
def test_staged_tail_on_card_matches_cpu(dev, bits, clip):
    m = _mat(10, EMNIST_BLOCK_LEAF, seed=7)
    w = torch.linspace(10, 60, 10)
    kw = dict(block_leaf=EMNIST_BLOCK_LEAF, n_leaves=8, bits=bits,
              clip_norm=clip, uniform=clip > 0,
              wsum_fixed=10.0 if clip else None)
    got, _ = ops.agg_tail(m.to(dev), w.to(dev), **kw)
    want, _ = ops.agg_tail(m, w, **kw)
    # the quantized operand is bitwise equal; the mean is a float32
    # matmul reduced in another order on the card
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-9)
