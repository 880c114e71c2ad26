"""The launch plans of the port's one-launch ``sumsq`` and cluster-route
``fake_quantize_flat``, held on the CPU where the kernels cannot run.

* ``sumsq``: a numpy emulation of the kernel's order (grid and chunk from
  ``dp_clip.sumsq_plan``, each thread's fmaf chain over its float4 quads,
  the tail on the last CTA's thread 0, the shuffle trees, the last CTA's
  index-order combine) is within ``dp_clip.sumsq_rtol(n)``, the a-priori
  bound the wrapper states, of the exact sum, and within twice that of the
  plain version ``ref.flat_sumsq_ref``. The fused multiply-add is
  emulated in long double, where the square is exact and the sum rounds
  once before the float32 rounding (a double rounding would need the
  long double result to land on a float32 tie; not in these data). On a
  card, the kernel gives the emulation's bits (marked ``cuda``).
* ``fake_quantize_flat``: the route chooser at both sides of its
  boundaries and at the EMNIST (87 blocks), FedAvg (1,656) and ragged
  maps, and the cluster route's split of a row's blocks over its CTAs:
  every block held by exactly one CTA, none over its register budget.

Imports neither JAX nor the JAX package, so the card test runs on the
card's machine as well:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_plans.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import flat as tflat
from repro_torch.kernels import dp_clip, quantize, ref

SUMSQ_SIZES = [0, 1, 3, 1023, 89_088, 89_088 + 77, 1_695_744, 3_000_001]


def _fma_sq(v, acc):
    """float32 fmaf(v, v, acc): v * v is exact in long double (48 bits),
    the sum rounds once there, then to float32."""
    wide = np.asarray(acc, np.longdouble) + np.asarray(v, np.longdouble) ** 2
    return wide.astype(np.float32)


def _block_sum(a):
    """(G, 256) float32 -> (G,) the kernel's block_sum: a shuffle-down tree
    in each warp (lane l adds lane l + off, off = 16 ... 1), then the same
    over the 8 warp sums in warp 0."""
    w = a.reshape(a.shape[0], 8, 32).copy()
    for off in (16, 8, 4, 2, 1):
        w[..., :off] = w[..., :off] + w[..., off:2 * off]
    s = w[..., 0].copy()
    for off in (4, 2, 1):
        s[:, :off] = s[:, :off] + s[:, off:2 * off]
    return s[:, 0]


def emulate_sumsq(x) -> np.float32:
    """The sumsq kernel's result, in its order, in numpy."""
    x = np.asarray(x, np.float32).reshape(-1)
    n, T = x.size, dp_clip.SUMSQ_THREADS
    grid, chunk = dp_clip.sumsq_plan(n)
    nq = n // 4
    quads = x[:4 * nq].reshape(nq, 4)
    acc = np.zeros((grid, T), np.float32)
    b, t = np.arange(grid)[:, None], np.arange(T)[None, :]
    for k in range(-(-chunk // T)):
        off = t + k * T
        q = b * chunk + off
        live = (off < chunk) & (q < nq)
        qq = np.where(live, q, 0)
        for j in range(4):
            acc = np.where(live, _fma_sq(quads[qq, j], acc), acc)
    for i in range(4 * nq, n):          # the tail, last CTA, thread 0
        acc[grid - 1, 0] = _fma_sq(x[i], acc[grid - 1, 0])
    partials = _block_sum(acc)
    p = np.zeros((1, T), np.float32)
    for k in range(-(-grid // T)):      # the last CTA, in index order
        idx = t + k * T
        live = idx < grid
        p = np.where(live, p + partials[np.where(live, idx, 0)], p)
    return _block_sum(p)[0]


def _vector(n):
    return np.random.default_rng(n).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", SUMSQ_SIZES)
def test_sumsq_order_within_its_a_priori_bound(n):
    x = _vector(n)
    got = float(emulate_sumsq(x))
    exact = math.fsum((x.astype(np.float64) ** 2).tolist())
    rtol = dp_clip.sumsq_rtol(n)
    assert rtol < 1e-5          # the card test's tolerance holds a priori
    assert abs(got - exact) <= rtol * exact
    plain = float(ref.flat_sumsq_ref(torch.from_numpy(x)))
    assert abs(got - plain) <= 2 * rtol * exact


@pytest.mark.parametrize("n", SUMSQ_SIZES)
def test_sumsq_plan_covers_the_vector(n):
    grid, chunk = dp_clip.sumsq_plan(n)
    assert 1 <= grid <= dp_clip.MAX_PARTIALS
    assert grid * chunk >= n // 4 and (grid - 1) * chunk < max(n // 4, 1)
    assert (grid, chunk) == dp_clip.sumsq_plan(n)   # from n alone


def test_sumsq_plan_fills_the_card_at_the_fedavg_width():
    assert dp_clip.sumsq_plan(1_695_744) == (132, 3212)   # one CTA an SM
    assert dp_clip.sumsq_plan(89_088) == (87, 256)        # a float4 a thread


EMNIST_BLOCKS = 87                       # the quickstart's 8-leaf row
FEDAVG_BLOCKS = 1656                     # every EMNIST parameter trainable
BOUNDARY = quantize.CLUSTER * quantize.CLUSTER_MAX_BLOCKS


@pytest.mark.parametrize("n_blocks,n_leaves,block,route", [
    (EMNIST_BLOCKS, 8, 1024, "cluster"),
    (FEDAVG_BLOCKS, 10, 1024, "two_pass"),
    (7, 4, 1024, "cluster"),             # the ragged map
    (1, 1, 1024, "cluster"),
    (BOUNDARY - 1, 8, 1024, "cluster"),
    (BOUNDARY, 8, 1024, "cluster"),
    (BOUNDARY + 1, 8, 1024, "two_pass"),
    (EMNIST_BLOCKS, quantize.CLUSTER_MAX_LEAVES, 1024, "cluster"),
    (EMNIST_BLOCKS, quantize.CLUSTER_MAX_LEAVES + 1, 1024, "two_pass"),
    (EMNIST_BLOCKS, 8, 512, "two_pass"),  # the kernel holds 1024-blocks
    (0, 1, 1024, "two_pass"),
])
def test_qdq_route(n_blocks, n_leaves, block, route):
    assert BOUNDARY == 256
    assert quantize.qdq_route(n_blocks * block, block, n_leaves) == route


@pytest.mark.parametrize("n_blocks", [1, 7, EMNIST_BLOCKS, BOUNDARY - 1,
                                      BOUNDARY])
def test_cluster_split_covers_every_block_once(n_blocks):
    ctas, groups, per_thread = quantize.cluster_split(n_blocks)
    assert 1 <= ctas <= quantize.CLUSTER
    assert 1 <= groups <= quantize.CLUSTER_GROUPS
    assert per_thread in quantize.CLUSTER_PER_THREAD
    held = np.zeros(n_blocks, np.int64)
    for r in range(ctas):                # the kernel's b0 and count
        b0 = r * n_blocks // ctas
        count = (r + 1) * n_blocks // ctas - b0
        assert count >= 1                # no CTA idle
        for g in range(groups):          # a thread group's blocks
            mine = np.arange(g, count, groups)
            assert mine.size <= per_thread
            held[b0 + mine] += 1
    assert (held == 1).all()


def test_block_leaf_on_is_made_once_per_sizes():
    tree = {"a": torch.zeros((3, 700)), "b": torch.zeros((5,)),
            "c": torch.zeros((2, 1024))}
    one, two = tflat.FlatLayout.of(tree), tflat.FlatLayout.of(dict(tree))
    bl = one.block_leaf_on("cpu")
    assert bl.dtype == torch.int32 and bl.device.type == "cpu"
    np.testing.assert_array_equal(bl.numpy(), one.block_leaf())
    assert two.block_leaf_on(torch.device("cpu")) is bl


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", SUMSQ_SIZES)
def test_sumsq_kernel_is_the_emulated_order(dev, n):
    x = _vector(n)
    want = np.float32(emulate_sumsq(x)).view(np.int32)
    got = dp_clip.sumsq(torch.from_numpy(x).to(dev))
    assert got.cpu().numpy().view(np.int32) == want
    # a base off the 16-byte grid takes scalar loads in the same order
    buf = torch.zeros(n + 1, device=dev)
    buf[1:] = torch.from_numpy(x).to(dev)
    assert dp_clip.sumsq(buf[1:]).cpu().numpy().view(np.int32) == want
