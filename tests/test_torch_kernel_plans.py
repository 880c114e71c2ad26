"""The launch plans of the port's one-launch ``sumsq``, cluster-route
``fake_quantize_flat`` and ``clip_flat``, and run-per-thread
``seed_reconstruct``, held on the CPU where the kernels cannot run.

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
* ``leaf_maxabs``: the fold kernel's plan (``quantize.maxabs_plan``)
  gives every (row, piece) tile to exactly one warp, no CTA idle, within
  the grid's cap and 32-bit index math, from 1 to 65,535 rows; a numpy
  emulation of the kernel (each warp's consecutive pieces of one (row,
  leaf) folded into one max, one atomic max a run) gives
  ``ref.leaf_maxabs_ref``'s bits on contiguous, ragged and ``% 5`` maps,
  with NaN, +-Inf, -0.0 and an all-zero leaf, for 1024-, 512- and
  2048-element blocks, with far fewer atomics than blocks at the FedAvg
  width.
* ``clip_flat``: the route chooser at both sides of each limit (blocks,
  n % 4) and the cluster split; a numpy emulation of the clip's order
  (each block's sum of squares in the plain halving order, each float32
  operation rounded on its own, then the row combine of the three-launch
  route's row_scale_kernel: thread t of 256 sums the blocks t, t + 256,
  ... from 0, then a halving tree) is within ``dp_clip.norm_rtol(n)`` of
  the plain version's norms, and gives the same bits whether the row's
  blocks are split over 1, 8, 12 or 16 CTAs: a CTA writes each block's
  sum by block index and every CTA combines all of them in one order.
* ``seed_reconstruct``: the kernel's thread -> (row, col, run) plan
  (``seed_reconstruct.seed_threads``) covers every element of the padded
  output exactly once, and its 32-bit counters are the plain version's
  index (and hash to its words) wherever the plan is enumerated, past the
  32-bit wrap too.
* ``swa_attention``: ``tile_plan`` and ``visible_pairs`` (the CPU twins
  of the tiles the attention kernel reads and masks, and of the pairs
  behind its bound) with a bidirectional prefix and with other rows in q
  than in k, against a brute-force mask (the reference's: (k <= q or k <
  prefix) and q - k < window under the causal mask, every key
  otherwise).

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
from repro_torch.kernels import swa_attention as swa

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


# --- leaf_maxabs: the fold kernel's plan and run folding --------------------

FEDAVG_N = FEDAVG_BLOCKS * 1024          # 1,695,744
FEDAVG_MAP = np.repeat(np.arange(10, dtype=np.int32),
                       [1, 1, 1, 50, 1, 1568, 1, 31, 1, 1])
RAGGED_MAP = np.array([0, 1, 1, 1, 2, 2, 3], np.int32)


def _warp_ranges(rows, n, block=1024):
    """(grid, per_warp, pieces, starts, stops) of the kernel's warps."""
    grid, per_warp = quantize.maxabs_plan(rows, n, block)
    pieces = rows * (n // quantize.maxabs_piece(block))
    starts = np.arange(grid * quantize.MAXABS_WARPS, dtype=np.int64) * per_warp
    return grid, per_warp, pieces, starts, np.minimum(starts + per_warp,
                                                      pieces)


@pytest.mark.parametrize("rows,n_blocks", [
    (r, nb) for r in (1, 65_535) for nb in (1, 87, 257, FEDAVG_BLOCKS)]
    + [(5, FEDAVG_BLOCKS), (10, FEDAVG_BLOCKS), (6, FEDAVG_BLOCKS),
       (10, EMNIST_BLOCKS)])
def test_maxabs_plan_covers_every_tile_once(rows, n_blocks):
    grid, per_warp, pieces, starts, stops = _warp_ranges(rows,
                                                         n_blocks * 1024)
    assert 1 <= grid <= quantize.MAXABS_MAX_CTAS and per_warp >= 1
    assert grid * quantize.MAXABS_WARPS * per_warp < 2 ** 31
    # warp ranges are consecutive and end at the last tile: each tile once
    live = starts < pieces
    assert (stops[live][:-1] == starts[live][1:]).all()
    assert starts[0] == 0 and stops[live][-1] == pieces
    # the last CTA holds a tile; one tile a warp whenever the cap allows
    assert (grid - 1) * quantize.MAXABS_WARPS * per_warp < pieces
    cap = quantize.MAXABS_MAX_CTAS * quantize.MAXABS_WARPS
    assert per_warp == max(1, -(-pieces // cap))
    if pieces <= 2 ** 22:                # enumerate where that is cheap
        held = np.zeros(pieces, np.int64)
        for a, b in zip(starts[live], stops[live]):
            held[a:b] += 1
        assert (held == 1).all()


def test_maxabs_plan_at_the_measured_shapes():
    assert quantize.maxabs_plan(10, 89_088) == (109, 1)
    assert quantize.maxabs_plan(10, FEDAVG_N) == (259, 8)
    assert quantize.maxabs_plan(6, FEDAVG_N) == (249, 5)


@pytest.mark.parametrize("block,piece", [(1024, 1024), (128, 128),
                                         (512, 512), (2048, 1024)])
def test_maxabs_piece(block, piece):
    assert quantize.maxabs_piece(block) == piece


@pytest.mark.parametrize("block", [4, 64, 100, 1000, 1536])
def test_maxabs_piece_refuses_other_blocks(block):
    with pytest.raises(ValueError):
        quantize.maxabs_piece(block)


def emulate_leaf_maxabs(x, block_leaf, n_leaves, block=1024):
    """The fold kernel in numpy: each piece's max of the sign-cleared int32
    bits, folded over each warp's consecutive pieces of one (row, leaf)
    (a run ends where the key changes or the warp's range does), one
    atomic max a run into a zeroed (rows, L) table. Returns (table as
    float32, atomics)."""
    rows, n = x.shape
    piece = quantize.maxabs_piece(block)
    grid, per_warp, pieces, starts, stops = _warp_ranges(rows, n, block)
    bits = (np.ascontiguousarray(x, np.float32).view(np.int32)
            & 0x7FFFFFFF).reshape(pieces, piece).max(axis=1)
    t = np.arange(pieces)
    per_row = n // piece
    leaf = np.asarray(block_leaf)[(t % per_row) // (block // piece)]
    key = (t // per_row) * n_leaves + leaf
    new_run = np.ones(pieces, bool)
    new_run[1:] = (key[1:] != key[:-1]) | (t[1:] % per_warp == 0)
    run_starts = np.flatnonzero(new_run)
    run_max = np.maximum.reduceat(bits, run_starts)
    table = np.zeros(rows * n_leaves, np.int32)
    np.maximum.at(table, key[run_starts], run_max)
    return table.view(np.float32).reshape(rows, n_leaves), run_starts.size


def _maxabs_rows(rows, n, seed):
    x = (np.random.default_rng(seed).normal(size=(rows, n)) * 1e-2).astype(
        np.float32)
    x[0, :1024] = 0.0                    # leaf 0 of row 0 all zero
    x[rows - 1, n // 3] = np.nan
    x[0, n - 5] = np.inf
    x[rows - 1, 7] = -np.inf
    x[rows // 2, min(1030, n - 1)] = -0.0
    return x


@pytest.mark.parametrize("rows,block_leaf,block", [
    (5, FEDAVG_MAP, 1024), (3, RAGGED_MAP, 1024),
    (2, np.arange(257, dtype=np.int32) % 5, 1024),
    (4, np.arange(87, dtype=np.int32) % 5, 1024),
    (1, np.zeros(1, np.int32), 1024),
    (3, RAGGED_MAP, 512), (3, np.arange(40, dtype=np.int32) % 5, 2048)])
def test_maxabs_run_folding_is_the_plain_bits(rows, block_leaf, block):
    n = block_leaf.size * block
    x = _maxabs_rows(rows, n, seed=rows + block)
    L = int(block_leaf.max()) + 1
    got, _ = emulate_leaf_maxabs(x, block_leaf, L, block)
    want = ref.leaf_maxabs_ref(torch.from_numpy(x), block_leaf, L, block)
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))


def test_maxabs_run_folding_cuts_the_atomics_at_the_fedavg_width():
    """One atomic a run: at (10, 1,695,744) at most one a warp plus one a
    leaf boundary inside a warp's range, against one a block (16,560)."""
    x = np.zeros((10, FEDAVG_N), np.float32)
    _, atomics = emulate_leaf_maxabs(x, FEDAVG_MAP, 10)
    grid, per_warp = quantize.maxabs_plan(10, FEDAVG_N)
    warps = -(-10 * FEDAVG_BLOCKS // per_warp)
    assert warps <= atomics <= warps + 10 * 9
    assert atomics < 10 * FEDAVG_BLOCKS / 7


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


# --- clip_flat: the route, the split, the order ------------------------------

CLIP_MAX = dp_clip.CLUSTER_MAX_BLOCKS * dp_clip.BLOCK


@pytest.mark.parametrize("n,route", [
    (89_088, "cluster"),                   # the async lane's row, 87 blocks
    (89_088 + 512, "cluster"),             # a ragged last block
    (89_088 + 77, "three_launch"),         # n % 4 == 1
    (89_088 + 2, "three_launch"),
    (89_088 + 3, "three_launch"),
    (4, "cluster"),
    (1000, "cluster"),                     # one ragged block
    (1, "three_launch"),
    (CLIP_MAX, "cluster"),                 # 512 blocks
    (CLIP_MAX - 1020, "cluster"),          # 512 blocks, the last ragged
    (CLIP_MAX + 4, "three_launch"),        # 513 blocks
    (1_695_744, "three_launch"),           # the FedAvg row, 1,656 blocks
])
def test_clip_route(n, route):
    assert CLIP_MAX == 524_288
    assert dp_clip.clip_route(n) == route


@pytest.mark.parametrize("n_blocks", [1, 3, 16, 17, 87, 88, 255, 511, 512])
def test_clip_split_gives_every_block_one_warp(n_blocks):
    ctas, warps = dp_clip.clip_split(n_blocks)
    assert 1 <= ctas <= dp_clip.CLUSTER and warps in dp_clip.CLUSTER_WARPS
    held = np.zeros(n_blocks, np.int64)
    for r in range(ctas):                # the kernel's b0 and count
        b0 = r * n_blocks // ctas
        count = (r + 1) * n_blocks // ctas - b0
        assert 1 <= count <= warps       # no CTA idle, one block a warp
        held[b0:b0 + count] += 1
    assert (held == 1).all()
    assert dp_clip.clip_split(87) == (16, 8)


def emulate_block_sums(row):
    """(n,) float32 -> (nb,) the clip's block sums of squares, each
    float32 product and sum rounded on its own: y[i] = x[i]^2 +
    x[i + 512]^2, then y[i] + y[i + h] while the width halves; a ragged
    last block reads zeros."""
    nb = -(-row.size // dp_clip.BLOCK)
    x = np.zeros(nb * dp_clip.BLOCK, np.float32)
    x[:row.size] = row
    x = x.reshape(nb, dp_clip.BLOCK)
    a, b = x[:, :512], x[:, 512:]
    y = a * a + b * b
    while y.shape[1] > 1:
        h = y.shape[1] // 2
        y = y[:, :h] + y[:, h:]
    return y[:, 0]


def emulate_clip_norm(row, ctas=1):
    """The clip's norm of one row, in the kernels' order: the row's blocks
    split over ``ctas`` CTAs as the cluster route splits them, each CTA
    writing its blocks' sums by block index; then the row combine."""
    sums = emulate_block_sums(row)
    nb = sums.size
    held = np.full(nb, np.nan, np.float32)
    for r in range(ctas):
        b0, b1 = r * nb // ctas, (r + 1) * nb // ctas
        held[b0:b1] = emulate_block_sums(
            row[b0 * dp_clip.BLOCK:b1 * dp_clip.BLOCK])
    part = np.zeros(256, np.float32)
    for k in range(-(-nb // 256)):       # thread t: blocks t, t + 256, ...
        idx = np.arange(256) + 256 * k
        live = idx < nb
        part = np.where(live, part + held[np.where(live, idx, 0)], part)
    while part.size > 1:
        h = part.size // 2
        part = part[:h] + part[h:]
    assert np.array_equal(held, sums)    # every block written, once
    return np.sqrt(part[0])


CLIP_SIZES = [1, 1000, 1024, 89_088, 89_088 + 512, 89_088 + 77, 1_695_744,
              3_000_001]


@pytest.mark.parametrize("n", CLIP_SIZES)
def test_clip_order_within_norm_rtol_of_plain(n):
    row = (_vector(n) * 1e-2).astype(np.float32)
    got = emulate_clip_norm(row)
    _, want = ref.flat_clip_ref(torch.from_numpy(row[None]), 0.5)
    want = float(want[0])
    assert abs(float(got) - want) <= dp_clip.norm_rtol(n) * want
    # the block sums are the plain version's, bit for bit
    nb = -(-n // dp_clip.BLOCK)
    if n % dp_clip.BLOCK == 0:
        plain = ref._sumsq_blocks(torch.from_numpy(row).reshape(nb, -1))
        assert np.array_equal(emulate_block_sums(row).view(np.int32),
                              plain.numpy().view(np.int32))


@pytest.mark.parametrize("n", [1000, 89_088, 89_088 + 512, CLIP_MAX])
def test_clip_order_does_not_depend_on_the_split(n):
    row = (_vector(n) * 1e-2).astype(np.float32)
    nb = -(-n // dp_clip.BLOCK)
    bits = {c: emulate_clip_norm(row, min(c, nb)).view(np.int32)
            for c in (1, 8, 12, 16)}
    assert bits[1] == bits[8] == bits[12] == bits[16]


# --- seed_reconstruct: the thread -> run plan --------------------------------

from repro_torch.kernels import seed_reconstruct as sr  # noqa: E402

SEED_SHAPES = [(300, 200), (1, 14336), (70000, 64), (5120, 14336),
               (70_000 * 1024 + 5,)]


def _live_runs(rows, cols, itemsize, blocks):
    """Rows, first cols and counters of the live threads of ``blocks``,
    in the order of (block, thread)."""
    b = np.repeat(blocks.astype(np.uint32), sr.THREADS)
    t = np.tile(np.arange(sr.THREADS, dtype=np.uint32), blocks.size)
    r, c0, live, ctr = sr.seed_threads(b, t, rows, cols, itemsize)
    return r[live], c0[live], ctr[live]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", SEED_SHAPES)
def test_seed_plan_covers_the_padded_output_once(shape, itemsize):
    rows, cols = ref.seed_dims(shape)
    run, cpad, tiles = sr.seed_plan(rows, cols, itemsize)
    assert run * itemsize == 16 and cpad % 128 == 0 and cpad >= cols
    assert rows * tiles < 2 ** 31       # one 1-D grid
    # the live threads, in (block, thread) order, hold the runs of the
    # padded output in row-major order: each element exactly once
    total = rows * cpad // run
    step = max(1, 2 ** 21 // sr.THREADS)
    seen = 0
    for b0 in range(0, rows * tiles, step):
        blocks = np.arange(b0, min(b0 + step, rows * tiles))
        r, c0, ctr = _live_runs(rows, cols, itemsize, blocks)
        pos = r.astype(np.int64) * (cpad // run) + c0.astype(np.int64) // run
        np.testing.assert_array_equal(pos, np.arange(seen, seen + pos.size))
        assert (c0.astype(np.int64) % run == 0).all()
        # the counter is the plain version's index over the logical cols
        idx = (r.astype(np.int64) * cols + c0.astype(np.int64)) & ref.M32
        np.testing.assert_array_equal(ctr.astype(np.int64), idx)
        seen += pos.size
    assert seen == total


def _check_words(rows, cols, itemsize, row):
    """The hash words of the counters the plan gives one row's runs equal
    ref.seed_bits_plain's for that row."""
    run, cpad, tiles = sr.seed_plan(rows, cols, itemsize)
    r, c0, ctr = _live_runs(rows, cols, itemsize,
                            np.arange(row * tiles, (row + 1) * tiles))
    assert (r == row).all()
    c = (c0[:, None].astype(np.int64) + np.arange(run)).reshape(-1)
    counters = ((ctr[:, None].astype(np.int64) + np.arange(run))
                & ref.M32).reshape(-1)[c < cols]
    sw = ref.seed_word(42, 7)
    b1, b2 = ref.seed_bits_plain(42, 7, 1, cols, row0=row)
    got1 = ref._squirrel3(torch.from_numpy((counters * 2) & ref.M32), sw)
    got2 = ref._squirrel3(torch.from_numpy((counters * 2 + 1) & ref.M32), sw)
    assert torch.equal(got1, b1[0]) and torch.equal(got2, b2[0])


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", SEED_SHAPES[:4])
def test_seed_plan_counters_hash_to_the_plain_words(shape, itemsize):
    rows, cols = ref.seed_dims(shape)
    for row in sorted({0, rows // 2, rows - 1}):
        _check_words(rows, cols, itemsize, row)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_seed_plan_counters_wrap_at_32_bits(itemsize):
    rows, cols = 100_000, 50_000          # 5e9 elements: past 2**32
    first = 2 ** 32 // cols               # the row the counter wraps in
    for row in (first - 1, first, first + 1, rows - 1):
        _check_words(rows, cols, itemsize, row)


def _brute_mask(sq, skv, window, causal, prefix):
    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    mask = ((qp >= kp) | (kp < prefix)) if causal else \
        np.ones((sq, skv), bool)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def _check_swa_plan(sq, skv, window, causal, prefix, bq, bk):
    """Every tile outside the plan's range holds no visible pair; every
    unmasked tile is whole and visible from each of the q tile's rows; the
    range's pairs are visible_pairs'."""
    mask = _brute_mask(sq, skv, window, causal, prefix)
    plan = swa.tile_plan(sq, window, causal, bq, bk, prefix_len=prefix,
                         skv=skv)
    assert len(plan) == -(-sq // bq)
    pairs = 0
    for i, (first, last, masked) in enumerate(plan):
        rows = mask[i * bq:(i + 1) * bq]
        assert 0 <= first <= last < -(-skv // bk)
        for t in range(-(-skv // bk)):
            tile = rows[:, t * bk:(t + 1) * bk]
            if t < first or t > last:
                assert not tile.any(), (i, t)
                continue
            pairs += int(tile.sum())
            if t not in masked:
                assert tile.shape[1] == bk and tile.all(), (i, t)
    assert pairs == int(mask.sum()) == swa.visible_pairs(
        sq, window, causal, prefix_len=prefix, skv=skv)


@pytest.mark.parametrize("sq,skv,window,causal,prefix", [
    (512, 512, 0, True, 256),     # PaliGemma: 256 patches + 256 tokens
    (320, 320, 0, True, 256),     # its consistency check's 256 + 64
    (300, 300, 0, True, 100),     # the prefix's edge inside a tile
    (300, 300, 50, True, 100),    # a window ANDed on the prefix mask
    (300, 300, 0, True, 300),     # all prefix: every key from every row
    (129, 129, 1, True, 64),      # window 1 past the prefix
    (300, 300, 0, False, 100),    # non-causal: the prefix changes nothing
    (448, 1500, 0, False, 0),     # Whisper's cross-attention
    (64, 1500, 0, False, 0),
    (1500, 448, 0, False, 0),
    (1, 1500, 0, False, 0),
    (1500, 1500, 0, False, 0)])   # Whisper's encoder
def test_swa_tile_plan_with_a_prefix_and_cross_rows(sq, skv, window, causal,
                                                    prefix):
    for bq in (64, swa.BQ):
        _check_swa_plan(sq, skv, window, causal, prefix, bq, swa.BK)


def test_swa_visible_pairs_at_the_new_cells():
    """The pairs behind the bounds of PaliGemma's and Whisper's calls."""
    # 256 prefix rows see 256 keys; text row r sees r + 1
    assert swa.visible_pairs(512, 0, prefix_len=256) == \
        256 * 256 + sum(range(257, 513))
    assert swa.visible_pairs(1500, 0, causal=False) == 1500 * 1500
    assert swa.visible_pairs(448, 0, causal=False, skv=1500) == 448 * 1500
    assert swa.visible_pairs(448, 0) == 448 * 449 // 2


def test_swa_tile_plan_random_shapes():
    """300 random (sq, skv, window, causal, prefix) against the brute mask
    (skv != sq only without the causal mask and a window, as the kernel
    takes them)."""
    rng = np.random.default_rng(3)
    for _ in range(300):
        causal = bool(rng.integers(2))
        sq = int(rng.integers(1, 400))
        skv = sq if causal or rng.integers(2) else int(rng.integers(1, 400))
        window = int(rng.integers(0, 300)) if skv == sq and \
            rng.integers(2) else 0
        prefix = int(rng.integers(0, skv + 1))
        _check_swa_plan(sq, skv, window, causal, prefix,
                        int(rng.choice([64, 128])), swa.BK)
