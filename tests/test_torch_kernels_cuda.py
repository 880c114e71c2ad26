"""The port's CUDA kernels against their plain torch versions, on the card.

Marked ``cuda``: every test skips where there is no CUDA device (here
the kernels cannot even be built). Run them on a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Imports neither JAX nor the JAX package. Max-abs and Q->DQ must match
bit for bit (NaN positions equal), Q->DQ on both of its routes (the
one-launch cluster route up to 256 blocks a row, the two-pass route
past it); sumsq within rtol 1e-5 of a float64 sum and with the same bits
on every run, 1,000 calls in a row and on two streams at once. The fused tail's kernels: block
max-abs, block sum of squares, int8 codes (on finite rows) and the apply
bit for bit; the quantized row sum of squares within a relative
2 * blocks * 2**-24 (the kernel sums the same per-block products in its
row combine's fixed order, the plain version in torch's order; each
float32 sum of n positive terms is within (n - 1) * 2**-24 of the exact
one); every
output the same on two runs. The DP clip kernels: the row clip's norms
within ``dp_clip.norm_rtol`` (its a-priori bound) of the plain version's
and its values within that plus three roundings; a row under the clip,
a zero row, a NaN row and an Inf row bit for bit; the clip-and-
accumulate within rtol 1e-6 of the plain version, whose norm is one
torch.sum. The row clip's one-launch cluster route (rows of n % 4 == 0 up
to 512 blocks) gives the three-launch route's bits, values and norms,
called through the library's C entry. ``leaf_maxabs``' fold kernel bit
for bit for 1 to 65 rows, 1 to 1,656 blocks and 1 to 300 leaves, the
edge values, an unaligned base, 100 calls in a row and two streams; each
call one memset and one kernel, and a leaf index outside [0, L) skipped.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import agg_tail, dp_clip, ops, quantize, ref
from repro_torch.core import sanitize
from repro_torch.nn import threefry

pytestmark = pytest.mark.cuda

EMNIST_BLOCK_LEAF = np.repeat(np.arange(8, dtype=np.int32),
                              [1, 1, 1, 50, 1, 31, 1, 1])
# every EMNIST CNN parameter trainable (the FedAvg baseline): 1,656 blocks
FEDAVG_BLOCK_LEAF = np.repeat(np.arange(10, dtype=np.int32),
                              [1, 1, 1, 50, 1, 1568, 1, 31, 1, 1])
RAGGED_BLOCK_LEAF = np.array([0, 1, 1, 1, 2, 2, 3], np.int32)


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


def _mat(rows, block_leaf, seed=0, case="random", n=None):
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((rows, n or block_leaf.size * 1024), generator=g) * 1e-2
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


@pytest.mark.parametrize("n", [0, 1, 3, 1023, 89_088, 89_088 + 77,
                               1_695_744, 3_000_001])
def test_sumsq_matches_float64_and_is_deterministic(dev, n):
    x = torch.randn(n, generator=torch.Generator().manual_seed(n)).to(dev)
    got = dp_clip.sumsq(x)
    want = float((x.double() ** 2).sum())
    assert float(got) == pytest.approx(want, rel=1e-5, abs=1e-30)
    assert torch.equal(got, dp_clip.sumsq(x))


def test_sumsq_same_bits_on_1000_calls(dev):
    """The last CTA sets the arrival counter back to 0: call after call
    combines in the same order."""
    x = torch.randn(89_088, generator=torch.Generator().manual_seed(1)).to(dev)
    first = dp_clip.sumsq(x)
    outs = torch.stack([dp_clip.sumsq(x) for _ in range(1000)])
    assert torch.equal(outs, first.expand(1000))


def test_sumsq_on_two_streams_matches_one(dev):
    """Each stream has its own partials and counter, so calls running at
    once on two streams give the one-stream bits."""
    g = torch.Generator().manual_seed(2)
    xs = [torch.randn(1_695_744, generator=g).to(dev) for _ in range(2)]
    want = [dp_clip.sumsq(x) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(50):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(dp_clip.sumsq(xs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(torch.equal(o, want[i]) for o in outs[i])


def test_wrappers_count_launches_and_check_inputs(dev):
    kernels.reset_launches()
    x = _mat(2, EMNIST_BLOCK_LEAF).to(dev)
    dp_clip.sumsq(x[0].contiguous())
    quantize.fake_quantize_flat(x, EMNIST_BLOCK_LEAF, 8)
    # the EMNIST row takes the cluster route: one launch, no max-abs pass
    assert kernels.ROUTES == {"fake_quantize_flat/cluster": 1,
                              "fake_quantize_flat/two_pass": 0,
                              "clip_flat/cluster": 0,
                              "clip_flat/three_launch": 0}
    assert kernels.LAUNCHES == {"sumsq": 1, "leaf_maxabs": 0,
                                "fake_quantize_flat": 1, "block_stats": 0,
                                "pack": 0, "apply_coeff": 0, "clip_flat": 0,
                                "clip_accumulate": 0, "swa_attention": 0,
                                "seed_reconstruct": 0}
    with pytest.raises(TypeError):
        dp_clip.sumsq(x[0].double())
    with pytest.raises(ValueError):
        dp_clip.sumsq(x[:, ::2][0])     # not contiguous
    with pytest.raises(ValueError):
        quantize.leaf_maxabs(x[:, :1000].contiguous(), EMNIST_BLOCK_LEAF, 8)
    with pytest.raises(ValueError):
        quantize.leaf_maxabs(x, EMNIST_BLOCK_LEAF + 1, 8)


def _qdq_matches_plain(m, block_leaf, bits=8):
    """fake_quantize_flat against its plain version, bit for bit; returns
    the route the launch took."""
    L = int(np.max(np.asarray(block_leaf))) + 1
    kernels.reset_launches()
    got = quantize.fake_quantize_flat(m, block_leaf, L, bits=bits)
    assert same_bits(got, ref.fake_quantize_flat_ref(m, block_leaf, bits=bits,
                                                     n_leaves=L))
    assert same_bits(quantize.fake_quantize_flat(m, block_leaf, L, bits=bits),
                     got)
    route = quantize.qdq_route(m.shape[-1], 1024, L)
    assert kernels.ROUTES[f"fake_quantize_flat/{route}"] == 2
    assert kernels.LAUNCHES["leaf_maxabs"] == (2 if route == "two_pass" else 0)
    return route


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
@pytest.mark.parametrize("rows", [1, 6, 10, 12, 65])
def test_qdq_cluster_route_matches_plain_bitwise(dev, rows, case):
    m = _mat(rows, EMNIST_BLOCK_LEAF, seed=rows, case=case).to(dev)
    assert _qdq_matches_plain(m, EMNIST_BLOCK_LEAF) == "cluster"


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
@pytest.mark.parametrize("rows", [1, 10])
def test_qdq_two_pass_route_matches_plain_bitwise(dev, rows, case):
    m = _mat(rows, FEDAVG_BLOCK_LEAF, seed=rows, case=case).to(dev)
    assert _qdq_matches_plain(m, FEDAVG_BLOCK_LEAF) == "two_pass"


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("n_blocks,route", [(255, "cluster"), (256, "cluster"),
                                            (257, "two_pass")])
def test_qdq_at_the_route_boundary(dev, n_blocks, route, bits):
    block_leaf = (np.arange(n_blocks, dtype=np.int32) * 7) % 5
    m = _mat(3, block_leaf, seed=n_blocks, case="nan").to(dev)
    assert _qdq_matches_plain(m, block_leaf, bits) == route


@pytest.mark.parametrize("case", ["random", "nan"])
def test_qdq_non_contiguous_leaf_map(dev, case):
    block_leaf = np.array([0, 1, 0, 2], np.int32)
    m = _mat(5, block_leaf, seed=3, case=case).to(dev)
    assert _qdq_matches_plain(m, block_leaf) == "cluster"
    # the same on a device map, and on rows whose base is off the
    # 16-byte grid (scalar loads and stores)
    bl = torch.as_tensor(block_leaf, device=dev)
    want = quantize.fake_quantize_flat(m, block_leaf, 3)
    assert same_bits(quantize.fake_quantize_flat(m, bl, 3), want)
    buf = torch.zeros(m.numel() + 1, device=dev)
    buf[1:] = m.reshape(-1)
    off = buf[1:].view(m.shape)
    assert same_bits(quantize.fake_quantize_flat(off, bl, 3), want)


# ---------------------------------------------------------------------------
# leaf_maxabs: a memset, then the fold kernel


def _maxabs_map(n_blocks, n_leaves):
    if n_leaves == 10 and n_blocks == FEDAVG_BLOCK_LEAF.size:
        return FEDAVG_BLOCK_LEAF
    if n_leaves == 300:
        return np.random.default_rng(n_blocks).integers(
            0, 300, n_blocks).astype(np.int32)
    return np.arange(n_blocks, dtype=np.int32) % n_leaves


def _maxabs_rows(dev, rows, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((rows, n), generator=g, device=dev) * 1e-2


def _maxabs_matches_plain(m, block_leaf, n_leaves):
    """leaf_maxabs against its plain version, bit for bit, the call's
    launch counted."""
    kernels.reset_launches()
    got = quantize.leaf_maxabs(m, block_leaf, n_leaves)
    assert same_bits(got, ref.leaf_maxabs_ref(m, block_leaf, n_leaves))
    assert kernels.LAUNCHES["leaf_maxabs"] == 1


@pytest.mark.parametrize("n_leaves", [1, 10, 300])
@pytest.mark.parametrize("n_blocks", [1, 87, 257, 1656])
@pytest.mark.parametrize("rows", [1, 6, 10, 40, 65])
def test_leaf_maxabs_matches_plain_bitwise(dev, rows, n_blocks, n_leaves):
    block_leaf = _maxabs_map(n_blocks, n_leaves)
    m = _maxabs_rows(dev, rows, n_blocks * 1024, rows * 7 + n_blocks)
    _maxabs_matches_plain(m, block_leaf, n_leaves)
    # the map as an int32 tensor on the card, taken as it is
    bl = torch.as_tensor(block_leaf, device=dev)
    assert same_bits(quantize.leaf_maxabs(m, bl, n_leaves),
                     ref.leaf_maxabs_ref(m, block_leaf, n_leaves))


@pytest.mark.parametrize("case", ["nan", "inf", "-inf", "-0.0", "zero_leaf"])
@pytest.mark.parametrize("rows,block_leaf", [(10, FEDAVG_BLOCK_LEAF),
                                             (6, EMNIST_BLOCK_LEAF),
                                             (65, RAGGED_BLOCK_LEAF)])
def test_leaf_maxabs_edge_values(dev, rows, block_leaf, case):
    n = block_leaf.size * 1024
    m = _maxabs_rows(dev, rows, n, rows)
    blocks3 = np.flatnonzero(block_leaf == 3)     # leaf 3, contiguous
    leaf3 = slice(int(blocks3[0]) * 1024, (int(blocks3[-1]) + 1) * 1024)
    if case == "nan":
        m[rows - 1, n // 3] = float("nan")
    elif case in ("inf", "-inf"):
        m[rows // 2, n - 9] = float(case)
    elif case == "-0.0":        # a block of -0.0: its leaf's max is +0.0
        m[0, :] = 0.0
        m[0, leaf3] = -0.0
    else:
        m[rows - 1, leaf3] = 0.0
        m[rows - 1, :1024] = 0.0
    L = int(block_leaf.max()) + 1
    _maxabs_matches_plain(m, block_leaf, L)


def test_leaf_maxabs_unaligned_base(dev):
    """A base off the 16-byte grid takes scalar loads in the same order."""
    m = _maxabs_rows(dev, 10, FEDAVG_BLOCK_LEAF.size * 1024, 3)
    m[2, 77] = float("nan")
    buf = torch.zeros(m.numel() + 1, device=dev)
    buf[1:] = m.reshape(-1)
    off = buf[1:].view(m.shape)
    assert off.data_ptr() % 16 != 0
    want = ref.leaf_maxabs_ref(m, FEDAVG_BLOCK_LEAF, 10)
    assert same_bits(quantize.leaf_maxabs(off, FEDAVG_BLOCK_LEAF, 10), want)
    rag = buf[1:1 + 3 * RAGGED_BLOCK_LEAF.size * 1024].view(3, -1)
    assert same_bits(quantize.leaf_maxabs(rag, RAGGED_BLOCK_LEAF, 4),
                     ref.leaf_maxabs_ref(rag, RAGGED_BLOCK_LEAF, 4))


@pytest.mark.parametrize("block", [128, 512, 2048])
def test_leaf_maxabs_other_blocks(dev, block):
    block_leaf = np.arange(40, dtype=np.int32) % 5
    m = _maxabs_rows(dev, 6, block_leaf.size * block, block)
    assert same_bits(quantize.leaf_maxabs(m, block_leaf, 5, block=block),
                     ref.leaf_maxabs_ref(m, block_leaf, 5, block))
    with pytest.raises(ValueError):     # not a block the kernel takes
        quantize.leaf_maxabs(torch.zeros((2, 6000), device=dev),
                             np.zeros(6, np.int32), 1, block=1000)


def test_leaf_maxabs_100_calls_in_a_row(dev):
    """Calls that alternate a large and a small buffer each give their own
    maxima."""
    n = FEDAVG_BLOCK_LEAF.size * 1024
    big = _maxabs_rows(dev, 10, n, 1) * 1e3
    small = _maxabs_rows(dev, 10, n, 2)
    want = [ref.leaf_maxabs_ref(x, FEDAVG_BLOCK_LEAF, 10)
            for x in (big, small)]
    bl = torch.as_tensor(FEDAVG_BLOCK_LEAF, device=dev)
    kernels.reset_launches()
    outs = [quantize.leaf_maxabs((big, small)[i % 2], bl, 10)
            for i in range(100)]
    assert kernels.LAUNCHES["leaf_maxabs"] == 100
    for i, o in enumerate(outs):
        assert same_bits(o, want[i % 2])


def test_leaf_maxabs_on_two_streams_matches_one(dev):
    """Calls running at once on two streams give the one-stream bits."""
    n = FEDAVG_BLOCK_LEAF.size * 1024
    xs = [_maxabs_rows(dev, 6, n, 5) * 10, _maxabs_rows(dev, 6, n, 6)]
    bl = torch.as_tensor(FEDAVG_BLOCK_LEAF, device=dev)
    want = [ref.leaf_maxabs_ref(x, FEDAVG_BLOCK_LEAF, 10) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for _ in range(50):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(quantize.leaf_maxabs(xs[i], bl, 10))
    torch.cuda.synchronize()
    for i in range(2):
        assert all(same_bits(o, want[i]) for o in outs[i])


def _device_ops(fn, calls=5):
    """Names of the device operations the profiler records over ``calls``
    calls of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


@pytest.mark.parametrize("rows,n_leaves", [(10, 10), (65, 300)])
def test_leaf_maxabs_device_ops(dev, rows, n_leaves):
    """A call is one memset of the output and one launch of the kernel."""
    block_leaf = _maxabs_map(257, n_leaves)
    m = _maxabs_rows(dev, rows, 257 * 1024, 9)
    bl = torch.as_tensor(block_leaf, device=dev)
    names = _device_ops(lambda: quantize.leaf_maxabs(m, bl, n_leaves))
    kernel = [x for x in names if "maxabs_fold_kernel" in x]
    memset = [x for x in names if "memset" in x.lower()]
    assert len(kernel) == len(memset) == 5
    assert len(kernel) + len(memset) == len(names)
    _maxabs_matches_plain(m, block_leaf, n_leaves)


@pytest.mark.parametrize("bad", [10, 1 << 20, -1])
def test_leaf_maxabs_skips_a_leaf_outside_the_table(dev, bad):
    """A card map is not checked on the host: a block whose leaf lies
    outside [0, L) folds into no leaf. Its values are the largest, so a
    write into a neighbouring row's word (leaf 10 or -1) would show."""
    block_leaf = FEDAVG_BLOCK_LEAF.copy()
    block_leaf[[0, 200, 1655]] = bad
    kept = torch.from_numpy(np.isin(block_leaf, np.arange(10))).to(dev)
    m = _maxabs_rows(dev, 10, block_leaf.size * 1024, 4)
    m.view(10, -1, 1024)[:, ~kept] = 1e3
    want = ref.leaf_maxabs_ref(m.view(10, -1, 1024)[:, kept].reshape(10, -1),
                               block_leaf[kept.cpu().numpy()], 10)
    got = quantize.leaf_maxabs(m, torch.as_tensor(block_leaf, device=dev), 10)
    assert same_bits(got, want)


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


@pytest.mark.parametrize("route", ["staged", "fused"])
def test_single_mesh_tail_is_the_unmeshed_tail(dev, route):
    """The tail on the 1-rank NCCL ``single`` mesh's flat plane launches
    the same kernels as often and gives the unmeshed tail's bits, with
    the screen, int8, the clip and DP noise."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shard_lib
    plane = shard_lib.flat_constrainer(mesh_lib.resolve_mesh("single"))
    m = _mat(10, FEDAVG_BLOCK_LEAF, seed=3).to(dev)
    w = torch.linspace(1, 2, 10, device=dev)
    kw = dict(block_leaf=torch.as_tensor(FEDAVG_BLOCK_LEAF, device=dev),
              n_leaves=10, bits=8, clip_norm=0.05, uniform=True,
              wsum_fixed=10.0, sigma=1e-3, rng=threefry.key(4),
              screen=sanitize.SanitizeConfig(),
              threshold=0 if route == "fused" else 1 << 62)
    outs, counts = [], []
    for constrain in (None, plane):
        kernels.reset_launches()
        out, info = ops.agg_tail(m if constrain is None
                                 else constrain(m, clients=True), w,
                                 constrain_fn=constrain, **kw)
        torch.cuda.synchronize()
        outs.append((out, info["update_norms"], info["norms"]))
        counts.append(dict(kernels.LAUNCHES))
    assert counts[0] == counts[1] and sum(counts[0].values()) > 0
    for a, b in zip(*outs):
        assert same_bits(a, b)


def _int32_max_with(other):
    """``FlatPlane.max_model`` over two "model" ranks, the other rank's
    per-leaf max-abs given: an int32 max of the float32 bit patterns."""
    return lambda t: torch.maximum(t.contiguous().view(torch.int32),
                                   other.view(torch.int32)).view(
                                       torch.float32)


# a buffer split into two "model" halves at a block boundary, a leaf
# spanning both
HALVES = [(RAGGED_BLOCK_LEAF, 2), (FEDAVG_BLOCK_LEAF, 828)]


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf"])
@pytest.mark.parametrize("block_leaf,split", HALVES)
def test_qdq_on_model_halves_with_reduced_maxima_is_the_whole(
        dev, block_leaf, split, case):
    """The two-pass route a mesh's "model" ranks take: each column half of
    an (R, N) buffer Q->DQ'd with its per-leaf max-abs reduced against the
    other half's gives, put back together, the whole call's bits."""
    m = _mat(10, block_leaf, seed=5, case=case).to(dev)
    L = int(block_leaf.max()) + 1
    c = split * 1024
    halves = [(m[:, :c].contiguous(), block_leaf[:split]),
              (m[:, c:].contiguous(), block_leaf[split:])]
    maxima = [quantize.leaf_maxabs(h, bl, L) for h, bl in halves]
    kernels.reset_launches()
    outs = [quantize.fake_quantize_flat(h, bl, L,
                                        reduce_maxabs=_int32_max_with(
                                            maxima[1 - i]))
            for i, (h, bl) in enumerate(halves)]
    assert kernels.LAUNCHES["leaf_maxabs"] == 2
    assert kernels.ROUTES["fake_quantize_flat/two_pass"] == 2
    assert same_bits(torch.cat(outs, 1),
                     quantize.fake_quantize_flat(m, block_leaf, L))


@pytest.mark.parametrize("case", ["random", "zero_leaf"])
@pytest.mark.parametrize("block_leaf,split", HALVES)
def test_pack_on_model_halves_combines_to_the_whole(dev, block_leaf, split,
                                                    case):
    """compose on a mesh whose "model" axis splits the blocks: each half's
    codes and per-block quantized sums of squares are the whole call's,
    and pack's row combine over the gathered per-block sums gives the
    whole call's qss bit for bit."""
    m = _mat(10, block_leaf, seed=6, case=case).to(dev)
    L = int(block_leaf.max()) + 1
    bmax, _ = agg_tail.block_stats(m)
    sblock = ref.agg_scales_ref(bmax, block_leaf, 8, L)
    q, qss, bqss = agg_tail._pack_cuda(m, sblock, 8, 1024)
    c = split * 1024
    parts = [agg_tail._pack_cuda(m[:, a:b].contiguous(),
                                 sblock[:, a // 1024:b // 1024].contiguous(),
                                 8, 1024)
             for a, b in ((0, c), (c, m.shape[1]))]
    assert torch.equal(torch.cat([p[0] for p in parts], 1), q)
    gathered = torch.cat([p[2] for p in parts], 1)
    assert same_bits(gathered, bqss)
    kernels.reset_launches()
    assert same_bits(agg_tail._row_combine_cuda(gathered), qss)
    assert kernels.ROUTES["pack/row_combine"] == 1


# ---------------------------------------------------------------------------
# the fused tail: stats, pack, apply


def _fused_inputs(dev, rows, block_leaf, case, seed=0):
    m = _mat(rows, block_leaf, seed=seed, case=case).to(dev)
    L = int(block_leaf.max()) + 1
    return m, L


def _finite_rows(m):
    return torch.isfinite(m).all(dim=1).cpu()


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
@pytest.mark.parametrize("rows,block_leaf", [(10, FEDAVG_BLOCK_LEAF),
                                             (3, RAGGED_BLOCK_LEAF)])
def test_fused_kernels_match_plain(dev, rows, block_leaf, case):
    m, L = _fused_inputs(dev, rows, block_leaf, case)
    kernels.reset_launches()
    bmax, bsumsq = agg_tail.block_stats(m)
    want_max, want_ss = ref.agg_block_stats_ref(m, with_sumsq=True)
    assert same_bits(bmax, want_max)
    assert same_bits(bsumsq, want_ss)
    sblock = ref.agg_scales_ref(bmax, block_leaf, 8, L)
    q, qss = agg_tail.pack(m, sblock)
    want_q = ref.agg_pack_ref(m, sblock, 8)
    fin = _finite_rows(m)
    assert torch.equal(q.cpu()[fin], want_q.cpu()[fin])
    want_qss = ref.agg_quant_sumsq_ref(q, sblock)
    torch.testing.assert_close(qss.cpu()[fin], want_qss.cpu()[fin],
                               rtol=2 * block_leaf.size * 2.0 ** -24, atol=0)
    w = torch.linspace(0.5, 1.5, rows, device=dev)
    coeff = (w / w.sum())[:, None] * sblock
    coeff = torch.where(torch.isfinite(coeff), coeff, torch.zeros_like(coeff))
    noise = torch.randn(m.shape[1], generator=torch.Generator().manual_seed(
        1)).to(dev) * 1e-3
    for nz in (None, noise):
        got = agg_tail.apply_coeff(q, coeff, nz)
        assert same_bits(got, ref.agg_apply_ref(q, coeff, noise=nz))
    assert kernels.LAUNCHES == {"sumsq": 0, "leaf_maxabs": 0,
                                "fake_quantize_flat": 0, "block_stats": 1,
                                "pack": 1, "apply_coeff": 2, "clip_flat": 0,
                                "clip_accumulate": 0, "swa_attention": 0,
                                "seed_reconstruct": 0}
    # the same bits on a second run
    again = agg_tail.block_stats(m)
    assert same_bits(again[0], bmax) and same_bits(again[1], bsumsq)
    q2, qss2 = agg_tail.pack(m, sblock)
    assert torch.equal(q2, q) and same_bits(qss2, qss)
    assert same_bits(agg_tail.apply_coeff(q, coeff, noise),
                     agg_tail.apply_coeff(q, coeff, noise))
    if case == "nan":
        assert not bool(torch.isfinite(bmax).all(dim=1)[rows - 1])
    if case == "ties":
        assert torch.equal(q[0, 0, 1:255].cpu(),
                           torch.arange(-126.5, 127.0).round().to(torch.int8))


# leaves of 2048, 4096, 2048 and 6144 elements, as block maps for blocks of
# 64 and 2048: the ends of the kernels' block range
EDGE_N = 14336


def _edge_block_leaf(block):
    return np.repeat(np.arange(4, dtype=np.int32),
                     [n // block for n in (2048, 4096, 2048, 6144)])


@pytest.mark.parametrize("case", ["random", "zero_leaf", "nan", "inf",
                                  "ties"])
@pytest.mark.parametrize("rows", [1, 300])
@pytest.mark.parametrize("block", [64, 2048])
def test_fused_stats_and_pack_at_the_block_range_ends(dev, block, rows, case):
    """block_stats and pack at blocks of 64 and 2048 (the kernels' lane
    mapping at its narrowest, half a warp, and widest, 16 loads a lane),
    one row and 300: the same checks as at the FedAvg buffer."""
    block_leaf = _edge_block_leaf(block)
    m = _mat(rows, block_leaf, seed=block + rows, case=case, n=EDGE_N).to(dev)
    kernels.reset_launches()
    bmax, bsumsq = agg_tail.block_stats(m, block)
    want_max, want_ss = ref.agg_block_stats_ref(m, block, with_sumsq=True)
    assert same_bits(bmax, want_max) and same_bits(bsumsq, want_ss)
    sblock = ref.agg_scales_ref(bmax, block_leaf, 8, 4)
    q, qss = agg_tail.pack(m, sblock, 8, block)
    assert tuple(q.shape) == (rows, EDGE_N // block, block)
    fin = _finite_rows(m)
    assert torch.equal(q.cpu()[fin], ref.agg_pack_ref(m, sblock, 8,
                                                      block).cpu()[fin])
    want_qss = ref.agg_quant_sumsq_ref(q, sblock)
    torch.testing.assert_close(qss.cpu()[fin], want_qss.cpu()[fin],
                               rtol=2 * block_leaf.size * 2.0 ** -24, atol=0)
    assert kernels.LAUNCHES["block_stats"] == 1
    assert kernels.LAUNCHES["pack"] == 1
    again = agg_tail.block_stats(m, block)
    assert same_bits(again[0], bmax) and same_bits(again[1], bsumsq)
    q2, qss2 = agg_tail.pack(m, sblock, 8, block)
    assert torch.equal(q2, q) and same_bits(qss2, qss)
    if case in ("nan", "inf"):
        bad = rows - 1 if case == "nan" else 0
        assert not bool(torch.isfinite(bmax).all(dim=1)[bad])
    if case == "ties":
        assert torch.equal(q.reshape(rows, -1)[0, 1:255].cpu(),
                           torch.arange(-126.5, 127.0).round().to(torch.int8))
    if case == "zero_leaf":
        assert q.reshape(rows, -1)[0, 2048:3072].abs().max() == 0


def test_fused_kernels_refuse_an_unaligned_buffer(dev):
    """stats and pack read 16 bytes a load: a view that starts 4 bytes in
    raises instead of launching."""
    buf = _mat(2, RAGGED_BLOCK_LEAF, n=7 * 1024 + 1).to(dev).reshape(-1)
    m = buf[1:2 * 7 * 1024 + 1].view(2, 7 * 1024)
    assert m.is_contiguous() and m.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        agg_tail.block_stats(m)
    with pytest.raises(ValueError, match="aligned"):
        agg_tail.pack(m, torch.ones((2, 7), device=dev))


def test_fused_wrappers_check_inputs(dev):
    m = _mat(2, RAGGED_BLOCK_LEAF).to(dev)
    s = torch.ones((2, 7), device=dev)
    with pytest.raises(ValueError):
        agg_tail.block_stats(m[:, :1000].contiguous())
    with pytest.raises(ValueError):
        agg_tail.block_stats(m, block=1000)
    with pytest.raises(ValueError):
        agg_tail.pack(m, s[:, :6].contiguous())
    with pytest.raises(TypeError):
        agg_tail.apply_coeff(torch.zeros((2, 7, 1024), device=dev), s)
    q, _ = agg_tail.pack(m, s)
    with pytest.raises(ValueError):
        agg_tail.apply_coeff(q, s, torch.zeros(7 * 1024 + 1,
                                               device=dev)[1:])


@pytest.mark.parametrize("pipeline", ["quant", "dp_screen"])
def test_fused_tail_on_card_matches_cpu(dev, pipeline):
    m = _mat(10, RAGGED_BLOCK_LEAF, seed=5)
    m[2, 100] = float("nan")
    w = torch.linspace(10, 60, 10)
    kw = dict(block_leaf=RAGGED_BLOCK_LEAF, n_leaves=4, bits=8, threshold=0)
    if pipeline == "dp_screen":
        kw.update(clip_norm=0.05, uniform=True, wsum_fixed=10.0,
                  sigma=0.02 * 0.05, rng=threefry.key(3),
                  screen=sanitize.SanitizeConfig())
    else:
        m[2, 100] = 0.0
    kernels.reset_launches()
    got, ginfo = ops.agg_tail(m.to(dev), w.to(dev), **kw)
    want, winfo = ops.agg_tail(m, w, **kw)
    kind = "exact" if pipeline == "quant" else "coeff"
    assert ginfo["route"] == f"fused/cuda/{kind}"
    assert winfo["route"] == f"fused/torch/{kind}"
    assert kernels.LAUNCHES["block_stats"] == 1
    assert kernels.LAUNCHES["pack"] == 1
    assert kernels.LAUNCHES["apply_coeff"] == (1 if kind == "coeff" else 0)
    for key in ("nonfinite", "outlier"):
        if key in winfo:
            assert torch.equal(ginfo[key].cpu(), winfo[key])
    assert torch.isfinite(got).all()
    # the codes are bitwise the CPU's; the GEMV / the noise's erfinv
    # (log1p, sqrt) round differently on the card
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# the DP clip: clip_flat (rows) and clip_accumulate

CLIP = 0.5


def _clip_rows(n, seed=0):
    """Six rows: clipped, zero, under the clip, a NaN, an Inf, clipped."""
    g = torch.Generator().manual_seed(seed)
    m = torch.randn((6, n), generator=g) * 1e-2
    m[1] = 0.0
    m[2] *= 0.5 * CLIP / float(m[2].double().norm())
    m[3, n // 3] = float("nan")
    m[4, n // 2] = float("inf")
    m[5] *= 40.0
    return m


@pytest.mark.parametrize("n", [89_088, 89_088 + 512, 1_695_744, 1000,
                               89_088 + 77,
                               dp_clip.CLUSTER_MAX_BLOCKS * 1024 + 4])
def test_clip_flat_matches_plain(dev, n):
    m = _clip_rows(n, seed=n).to(dev)
    kernels.reset_launches()
    got, gnorm = dp_clip.clip_flat(m, CLIP)
    want, wnorm = ref.flat_clip_ref(m, CLIP)
    # one launch, on the route the shape picks (cluster: n % 4 == 0 up to
    # CLUSTER_MAX_BLOCKS blocks; else three launches)
    route = dp_clip.clip_route(n)
    assert route == ("cluster" if n % 4 == 0 and
                     n <= dp_clip.CLUSTER_MAX_BLOCKS * 1024 else "three_launch")
    assert kernels.LAUNCHES["clip_flat"] == 1
    assert kernels.ROUTES[f"clip_flat/{route}"] == 1
    rtol = dp_clip.norm_rtol(n)
    fin = torch.isfinite(wnorm)
    torch.testing.assert_close(gnorm[fin], wnorm[fin], rtol=rtol, atol=0)
    assert same_bits(gnorm[~fin], wnorm[~fin])
    for r in (0, 5):
        torch.testing.assert_close(got[r], want[r],
                                   rtol=rtol + 3 * 2.0 ** -24, atol=0)
    # under the clip: scale exactly 1; zero row; NaN and Inf rows
    for r in (1, 2, 3, 4):
        assert same_bits(got[r], want[r]), r
    assert same_bits(got[2], m[2]) and bool(torch.isnan(got[3]).all())
    # one row alone, and the same bits on a second run
    row, rnorm = dp_clip.clip_flat(m[0].contiguous(), CLIP)
    assert same_bits(row, got[0]) and same_bits(rnorm, gnorm[0])
    again, anorm = dp_clip.clip_flat(m, CLIP)
    assert same_bits(again, got) and same_bits(anorm, gnorm)


@pytest.mark.parametrize("n", [89_088, 1_695_744, 89_088 + 77])
def test_clip_accumulate_matches_plain(dev, n):
    g = torch.Generator().manual_seed(n)
    acc = (torch.randn(n, generator=g) * 1e-3).to(dev)
    for scale in (1e-2, 1e-5):       # clipped, and under the clip
        x = (torch.randn(n, generator=g) * scale).to(dev)
        kernels.reset_launches()
        got, gnorm = dp_clip.clip_accumulate(acc, x, CLIP)
        want, wnorm = ref.dp_clip_accumulate_ref(acc, x, CLIP)
        assert kernels.LAUNCHES["clip_accumulate"] == 1
        torch.testing.assert_close(gnorm, wnorm, rtol=1e-6, atol=0)
        # relative to the terms: acc + x * s may cancel
        err = (got - want).abs()
        bound = 1e-6 * (acc.abs() + (x * (CLIP / wnorm).clamp(max=1)).abs())
        assert bool((err <= bound + 1e-30).all())
        assert same_bits(dp_clip.clip_accumulate(acc, x, CLIP)[0], got)
        if scale == 1e-5:            # scale exactly 1: acc + x
            assert same_bits(got, acc + x)
    for value in (0.0, float("inf"), float("nan")):   # zero x, Inf, NaN
        xe = torch.zeros_like(x) if value == 0.0 else x.clone()
        xe[5] = value
        got, gnorm = dp_clip.clip_accumulate(acc, xe, CLIP)
        want, wnorm = ref.dp_clip_accumulate_ref(acc, xe, CLIP)
        assert same_bits(got, want) and same_bits(gnorm, wnorm), value


def _clip_cases(rows, n, seed=0):
    """``rows`` rows cycling through _clip_rows' six cases."""
    six = _clip_rows(n, seed)
    return six[torch.arange(rows) % 6].contiguous()


def _three_launch(m):
    """clip_flat's three-launch route, called through its C entry."""
    from repro_torch.kernels import _build
    R, n = m.shape
    lib = _build.load("dp_clip.cu", dp_clip._CLIP_SIGNATURES)
    out, norms = torch.empty_like(m), torch.empty(R, device=m.device)
    bss, scales = dp_clip._scratch(R, n, m.device)
    err = lib.dp_clip_rows_f32(m.data_ptr(), R, n, dp_clip.BLOCK, CLIP,
                               bss.data_ptr(), norms.data_ptr(),
                               scales.data_ptr(), out.data_ptr(),
                               _build.stream_ptr(m))
    assert err == 0
    return out, norms


CLIP_MAX = dp_clip.CLUSTER_MAX_BLOCKS * dp_clip.BLOCK


@pytest.mark.parametrize("rows,n", [
    (1, 89_088), (6, 89_088), (10, 89_088), (40, 89_088),
    (6, 89_088 + 512),                    # a ragged last block
    (6, 1000), (6, 1024),                 # one block
    (6, CLIP_MAX), (6, CLIP_MAX - 1020),  # the route's largest rows
])
def test_clip_cluster_route_matches_three_launch_bitwise(dev, rows, n):
    m = _clip_cases(rows, n, seed=n + rows).to(dev)
    assert dp_clip.clip_route(n) == "cluster"
    kernels.reset_launches()
    got, gnorm = dp_clip.clip_flat(m, CLIP)
    assert kernels.ROUTES["clip_flat/cluster"] == 1
    assert kernels.LAUNCHES["clip_flat"] == 1
    want, wnorm = _three_launch(m)
    assert same_bits(got, want) and same_bits(gnorm, wnorm)
    again, anorm = dp_clip.clip_flat(m, CLIP)
    assert same_bits(again, got) and same_bits(anorm, gnorm)
    # a base off the 16-byte grid takes scalar loads and stores
    buf = torch.empty(rows * n + 1, device=dev)
    off = buf[1:].view(rows, n)
    off.copy_(m)
    moved, mnorm = dp_clip.clip_flat(off, CLIP)
    assert same_bits(moved, got) and same_bits(mnorm, gnorm)


def test_clip_wrappers_check_inputs(dev):
    m = _clip_rows(2048).to(dev)
    with pytest.raises(TypeError):
        dp_clip.clip_flat(m.double(), CLIP)
    with pytest.raises(ValueError):
        dp_clip.clip_flat(m[:, ::2], CLIP)           # not contiguous
    with pytest.raises(ValueError):
        dp_clip.clip_accumulate(m[0], m[1, :1024].contiguous(), CLIP)
    with pytest.raises(ValueError):
        dp_clip.clip_accumulate(m[0].cpu(), m[1], CLIP)


# --- the serving path: sliding-window attention and seed reconstruction -----
#
# swa_attention against the dense plain version: the kernel rounds its
# float32 result to the output type once (half an ulp: 2**-8 relative in
# bf16, 2**-11 in fp16); the two float32 computations sum in other orders,
# ~1e-6 at these sizes, inside an absolute 1e-5 (and 2**-20 relative for
# float32 outputs). seed_reconstruct: hash words bit for bit; Gaussians
# within 8 ulps (CUDA's logf / cosf against torch's, 2 ulps each, a sqrt
# and two multiplies), bf16 within one bf16 ulp.

HALF_ULP = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}


def _qkv(dev, B, H, KVH, S, D, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((B, H, S, D), generator=g).to(dev, dtype),
            torch.randn((B, KVH, S, D), generator=g).to(dev, dtype),
            torch.randn((B, KVH, S, D), generator=g).to(dev, dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 100, 1000])
@pytest.mark.parametrize("B,H,KVH,S,D,dtype", [
    (1, 4, 2, 200, 64, torch.float32),       # GQA rep 2, 64-wide heads
    (2, 8, 2, 1000, 100, torch.bfloat16),    # a head dim below 128
    (1, 4, 4, 257, 128, torch.float16),      # ragged S, no GQA
    (1, 32, 8, 4000, 128, torch.bfloat16)])  # NeMo's heads, ragged S
def test_swa_attention_matches_plain(dev, B, H, KVH, S, D, dtype, window,
                                     causal):
    q, k, v = _qkv(dev, B, H, KVH, S, D, dtype, seed=S + window)
    kernels.reset_launches()
    got = ops.swa_attention(q, k, v, window=window, causal=causal)
    assert kernels.LAUNCHES["swa_attention"] == 1 and got.dtype == dtype
    want = ref.swa_attention_ref(q, k, v, window, causal)
    err = (got.float() - want).abs()
    assert bool((err <= HALF_ULP[dtype] * want.abs() + 1e-5).all()), \
        float(err.max())
    assert same_bits(ops.swa_attention(q, k, v, window=window,
                                       causal=causal), got)


BF16, FP16 = torch.bfloat16, torch.float16


# The tensor-core kernel's edges: S around its 128-row q tiles; windows
# whose edge falls inside a 64-key tile (1, 127), on a tile's boundary
# (128) and one past it (129); a window longer than S; GQA reps 1, 2 and
# 4; head dims 64, 100 and 128; bf16 and fp16; no causal mask. "bshd"
# passes transposed (B, S, H, D) views, the model's layout, which TMA
# reads (a D = 100 row of 200 bytes in a contiguous (B, H, S, D) tensor is
# not a multiple of 16 bytes: the kernel's copy loader reads those).
@pytest.mark.parametrize("B,H,KVH,S,D,dtype,window,causal,bshd", [
    (1, 4, 1, 127, 128, BF16, 0, True, False),
    (1, 4, 1, 128, 128, BF16, 0, True, True),
    (1, 4, 1, 129, 128, BF16, 0, True, False),
    (1, 8, 2, 4000, 128, BF16, 0, True, True),
    (1, 4, 4, 1000, 128, BF16, 1, True, False),
    (1, 4, 2, 1000, 128, FP16, 127, True, True),
    (1, 4, 2, 1000, 64, BF16, 128, True, False),
    (1, 4, 1, 1000, 128, BF16, 129, True, True),
    (1, 4, 2, 300, 128, FP16, 1000, True, False),
    (2, 4, 4, 300, 64, FP16, 0, True, True),
    (1, 8, 2, 500, 100, BF16, 129, True, True),
    (1, 8, 2, 500, 100, FP16, 0, True, False),
    (1, 4, 1, 129, 100, FP16, 0, False, False),
    (1, 4, 2, 1000, 128, BF16, 129, False, True),
    (1, 4, 4, 513, 64, BF16, 0, False, False)])
def test_swa_attention_tensor_core_edges(dev, B, H, KVH, S, D, dtype, window,
                                         causal, bshd):
    g = torch.Generator().manual_seed(S + D + window)

    def one(h):
        x = torch.randn((B, S, h, D), generator=g).to(dev, dtype)
        return x.transpose(1, 2) if bshd else x.transpose(1, 2).contiguous()
    q, k, v = one(H), one(KVH), one(KVH)
    kernels.reset_launches()
    got = ops.swa_attention(q, k, v, window=window, causal=causal)
    assert kernels.LAUNCHES["swa_attention"] == 1 and got.dtype == dtype
    want = ref.swa_attention_ref(q, k, v, window, causal)
    err = (got.float() - want).abs()
    assert bool((err <= HALF_ULP[dtype] * want.abs() + 1e-5).all()), \
        float(err.max())
    assert same_bits(ops.swa_attention(q, k, v, window=window,
                                       causal=causal), got)


# The round-once mode at the same edges, and at NeMo's heads and a ragged
# S = 4000: within bound (i) of its plain version
# ref.chunked_attention_ref(..., chunk=64) (swa_attention.round_p_tolerance
# derives it), closer to it (RMS) than the float32-p mode on the same
# inputs, the same bits twice.
@pytest.mark.parametrize("B,H,KVH,S,D,dtype,window,causal,bshd", [
    (1, 4, 1, 127, 128, BF16, 0, True, False),
    (1, 4, 1, 128, 128, BF16, 0, True, True),
    (1, 4, 1, 129, 128, BF16, 0, True, False),
    (1, 8, 2, 4000, 128, BF16, 0, True, True),
    (1, 4, 4, 1000, 128, BF16, 1, True, False),
    (1, 4, 2, 1000, 128, FP16, 127, True, True),
    (1, 4, 2, 1000, 64, BF16, 128, True, False),
    (1, 4, 1, 1000, 128, BF16, 129, True, True),
    (1, 4, 2, 300, 128, FP16, 1000, True, False),
    (2, 4, 4, 300, 64, FP16, 0, True, True),
    (1, 8, 2, 500, 100, BF16, 129, True, True),
    (1, 8, 2, 500, 100, FP16, 0, True, False),
    (1, 4, 1, 129, 100, FP16, 0, False, False),
    (1, 4, 2, 1000, 128, BF16, 129, False, True),
    (1, 4, 4, 513, 64, BF16, 0, False, False),
    (1, 32, 8, 4000, 128, BF16, 0, True, True),
    (1, 32, 8, 4000, 128, BF16, 1000, True, False)])
def test_swa_attention_round_p_edges(dev, B, H, KVH, S, D, dtype, window,
                                     causal, bshd):
    from repro_torch.kernels import swa_attention as swa
    g = torch.Generator().manual_seed(S + D + window)

    def one(h):
        x = torch.randn((B, S, h, D), generator=g).to(dev, dtype)
        return x.transpose(1, 2) if bshd else x.transpose(1, 2).contiguous()
    q, k, v = one(H), one(KVH), one(KVH)
    kernels.reset_launches()
    got = ops.swa_attention(q, k, v, window=window, causal=causal,
                            round_p=True)
    assert kernels.LAUNCHES["swa_attention"] == 1 and got.dtype == dtype
    want = ref.chunked_attention_ref(q, k, v, window, causal, chunk=swa.BK)
    tol = swa.round_p_tolerance(q, k, v, window, causal, got, want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    f32p = ops.swa_attention(q, k, v, window=window, causal=causal)
    rms = [float((a.float() - want.float()).pow(2).mean().sqrt())
           for a in (got, f32p)]
    if window != 1:   # one visible key: p = 1 in both modes, no rounding
        assert rms[0] < 0.5 * rms[1], rms
    assert same_bits(ops.swa_attention(q, k, v, window=window, causal=causal,
                                       round_p=True), got)


# MLA's head dims: q / k heads of 192 (128 + a 64-wide rope part) and v
# heads of 128 (the (192, 128) instance), and the reduced config's 48 / 32
# (zero-filled in the (64, 64) instance), in the model's (B, S, H, D)
# layout: the float32-p mode against the dense plain version (HALF_ULP),
# the round-once mode within bound (i) of chunked_attention_ref(chunk=64),
# a ragged S, the same bits twice.
@pytest.mark.parametrize("B,H,S,DK,DV,dtype,window,causal", [
    (1, 16, 4096, 192, 128, BF16, 0, True),
    (1, 16, 4000, 192, 128, BF16, 0, True),
    (1, 8, 1000, 192, 128, FP16, 129, True),
    (1, 8, 513, 192, 128, BF16, 0, False),
    (1, 4, 1000, 48, 32, torch.float32, 0, True),
    (1, 4, 1000, 192, 128, torch.float32, 100, True),
    (2, 4, 300, 48, 32, BF16, 0, True)])
def test_swa_attention_mla_head_dims(dev, B, H, S, DK, DV, dtype, window,
                                     causal):
    from repro_torch.kernels import swa_attention as swa
    g = torch.Generator().manual_seed(S + DK + window)
    q, k, v = (torch.randn((B, S, H, d), generator=g).to(dev, dtype)
               .transpose(1, 2) for d in (DK, DK, DV))
    kernels.reset_launches()
    got = ops.swa_attention(q, k, v, window=window, causal=causal)
    assert kernels.LAUNCHES["swa_attention"] == 1
    assert got.shape == (B, H, S, DV) and got.dtype == dtype
    want = ref.swa_attention_ref(q, k, v, window, causal)
    err = (got.float() - want).abs()
    assert bool((err <= HALF_ULP[dtype] * want.abs() + 1e-5).all()), \
        float(err.max())
    assert same_bits(ops.swa_attention(q, k, v, window=window,
                                       causal=causal), got)
    if dtype == torch.float32:
        return
    got = ops.swa_attention(q, k, v, window=window, causal=causal,
                            round_p=True)
    want = ref.chunked_attention_ref(q, k, v, window, causal, chunk=swa.BK)
    tol = swa.round_p_tolerance(q, k, v, window, causal, got, want)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    assert same_bits(ops.swa_attention(q, k, v, window=window, causal=causal,
                                       round_p=True), got)


# The VLM's and the encoder-decoder's calls: a bidirectional prefix under
# the causal mask (PaliGemma's 256 patches before 256 tokens, q / k / v
# heads of 256: the (256, 128) instance in two 128-wide v slices), with a
# window ANDed on it, all prefix; non-causal with Sq == Skv (Whisper's
# encoder) and Sq != Skv (its cross-attention, 448 tokens against 1,500
# frames), both ways, over more than one row of the batch; v wider than
# q / k; float32 on the CUDA cores at DK 256 and across rows. In the
# model's (B, S, H, D) layout: the float32-p
# mode against the dense plain version (HALF_ULP), the round-once mode
# within bound (i) of chunked_attention_ref(chunk=64), the same bits twice.
@pytest.mark.parametrize("B,H,KVH,SQ,SKV,DK,DV,dtype,window,causal,prefix", [
    (3, 8, 1, 512, 512, 256, 256, BF16, 0, True, 256),
    (1, 8, 1, 320, 320, 256, 256, FP16, 0, True, 256),
    (2, 4, 2, 300, 300, 128, 128, BF16, 50, True, 100),
    (1, 4, 1, 200, 200, 64, 64, BF16, 0, True, 200),
    (1, 4, 1, 300, 300, 256, 256, torch.float32, 0, True, 100),
    (2, 20, 20, 1500, 1500, 64, 64, BF16, 0, False, 0),
    (2, 20, 20, 448, 1500, 64, 64, BF16, 0, False, 0),
    (2, 4, 4, 7, 300, 128, 128, FP16, 0, False, 0),
    (1, 4, 2, 300, 7, 64, 64, BF16, 0, False, 0),
    (1, 4, 4, 100, 300, 64, 64, torch.float32, 0, False, 0),
    (1, 4, 1, 300, 300, 128, 256, BF16, 0, True, 0)])
def test_swa_attention_prefix_cross_and_wide_heads(dev, B, H, KVH, SQ, SKV,
                                                   DK, DV, dtype, window,
                                                   causal, prefix):
    from repro_torch.kernels import swa_attention as swa
    g = torch.Generator().manual_seed(SQ + SKV + DK + prefix)

    def one(s, h, d):
        return torch.randn((B, s, h, d), generator=g).to(dev, dtype) \
            .transpose(1, 2)
    q, k, v = one(SQ, H, DK), one(SKV, KVH, DK), one(SKV, KVH, DV)
    kw = dict(window=window, causal=causal, prefix_len=prefix)
    kernels.reset_launches()
    got = ops.swa_attention(q, k, v, **kw)
    assert kernels.LAUNCHES["swa_attention"] == 1
    assert got.shape == (B, H, SQ, DV) and got.dtype == dtype
    want = ref.swa_attention_ref(q, k, v, window, causal, prefix_len=prefix)
    err = (got.float() - want).abs()
    assert bool((err <= HALF_ULP[dtype] * want.abs() + 1e-5).all()), \
        float(err.max())
    assert same_bits(ops.swa_attention(q, k, v, **kw), got)
    if dtype == torch.float32:
        return
    got = ops.swa_attention(q, k, v, round_p=True, **kw)
    want = ref.chunked_attention_ref(q, k, v, window, causal, chunk=swa.BK,
                                     prefix_len=prefix)
    tol = swa.round_p_tolerance(q, k, v, window, causal, got, want,
                                prefix_len=prefix)
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol).all()), float((err / tol).max())
    assert same_bits(ops.swa_attention(q, k, v, round_p=True, **kw), got)


@pytest.mark.parametrize("arch,launches", [("paligemma-3b", 2),
                                           ("whisper-large-v3", 6)])
def test_vlm_and_encdec_decoders_on_card_match_cpu(dev, arch, launches):
    """Reduced PaliGemma (a prefix of 8 patches) and Whisper (16 frames)
    in float32: forward logits on the card (the kernel in every attention
    call: PaliGemma's 2 layers; Whisper's 2 encoder, 2 decoder and 2
    cross-attention calls) against the CPU (the chunked plain version),
    rtol / atol 1e-4, and greedy tokens (text only, as the reference's
    ``generate``) equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn.basic import tree_map
    cfg = reduced_config(get_config(arch))
    params = dlm.init_model(cfg, 0, device="cpu")
    on_card = tree_map(lambda x: x.to(dev), params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 40)))
    kw = ({"prefix_embeds": torch.from_numpy(rng.standard_normal(
        (2, cfg.num_prefix_tokens, 1152)).astype(np.float32))}
        if cfg.family == "vlm" else
        {"encoder_embeds": torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32))})
    kernels.reset_launches()
    got, _ = dlm.forward(on_card, cfg, toks.to(dev),
                         **{n: t.to(dev) for n, t in kw.items()})
    assert kernels.LAUNCHES["swa_attention"] == launches
    want, _ = dlm.forward(params, cfg, toks, **kw)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    seq_card = serve.generate(on_card, cfg, toks[:, :8], 16, device=dev)
    seq_cpu = serve.generate(params, cfg, toks[:, :8], 16, device="cpu")
    assert torch.equal(seq_card.cpu(), seq_cpu)


def test_mla_decoder_on_card_matches_cpu(dev):
    """Reduced DeepSeek-V2 (MLA, q / k heads of 48, v heads of 32) in
    float32: forward logits on the card (the kernel, once a layer) against
    the CPU (the chunked plain version), rtol / atol 1e-4, and greedy
    tokens from the compressed cache equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn.basic import tree_map
    cfg = reduced_config(get_config("deepseek-v2-236b")).with_(
        moe_capacity_factor=8.0)
    params = dlm.init_model(cfg, 0, device="cpu")
    on_card = tree_map(lambda x: x.to(dev), params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 40)))
    kernels.reset_launches()
    got, _ = dlm.forward(on_card, cfg, toks.to(dev))
    assert kernels.LAUNCHES["swa_attention"] == cfg.num_layers
    want, _ = dlm.forward(params, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    seq_card = serve.generate(on_card, cfg, toks[:, :8], 16, device=dev)
    seq_cpu = serve.generate(params, cfg, toks[:, :8], 16, device="cpu")
    assert torch.equal(seq_card.cpu(), seq_cpu)


def test_swa_attention_reads_strided_layouts(dev):
    """The model's (B, S, H, D) tensors go in as transposed views and the
    output is written into a transposed view: the same bits as the
    contiguous call."""
    g = torch.Generator().manual_seed(1)
    bshd = [torch.randn((2, 300, h, 128), generator=g).to(dev, torch.bfloat16)
            for h in (8, 2, 2)]
    views = [t.transpose(1, 2) for t in bshd]
    out = torch.empty_like(bshd[0])
    res = ops.swa_attention(*views, window=70, out=out.transpose(1, 2))
    want = ops.swa_attention(*(t.contiguous() for t in views), window=70)
    assert res.data_ptr() == out.data_ptr()
    assert same_bits(out.transpose(1, 2), want)


def test_swa_attention_checks_inputs(dev):
    q, k, v = _qkv(dev, 1, 4, 2, 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        ops.swa_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        ops.swa_attention(q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1))
    # q / k heads and v heads above 256 (256 / 256 is PaliGemma's, taken)
    with pytest.raises(ValueError):
        ops.swa_attention(*_qkv(dev, 1, 2, 1, 8, 320, torch.bfloat16))
    qm, km, _ = _qkv(dev, 1, 2, 1, 8, 192, torch.bfloat16)
    vm = _qkv(dev, 1, 2, 1, 8, 320, torch.bfloat16)[2]
    with pytest.raises(ValueError):
        ops.swa_attention(qm, km, vm)
    # other rows in q than in k only for a non-causal call without a
    # window; a prefix inside [0, Skv]
    kx, vx = k[:, :, :40], v[:, :, :40]
    for kw in ({}, {"causal": False, "window": 8}):
        with pytest.raises(ValueError):
            ops.swa_attention(q, kx, vx, **kw)
    with pytest.raises(ValueError):
        ops.swa_attention(q, k, v, prefix_len=65)
    with pytest.raises(ValueError):
        ops.swa_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):
        ops.swa_attention(q[..., ::2], k[..., ::2], v[..., ::2])


def test_flash_attention_on_card_is_the_kernel(dev):
    """``nn/attention.flash_attention`` on CUDA tensors launches the kernel,
    and agrees with the plain chunked version run on the card: that one
    rounds p to bf16 before PV (2**-9 of each term, so 2**-9 of max |v|),
    and both round the output to bf16."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.nn import attention
    cfg = reduced_config(get_config("mistral-nemo-12b")).with_(
        num_kv_heads=2, sliding_window=100)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 600, h, 64), generator=g).to(dev, torch.bfloat16)
               for h in (4, 2, 2))
    kernels.reset_launches()
    got = attention.flash_attention(q, k, v, cfg)
    assert kernels.LAUNCHES["swa_attention"] == 1
    want = attention.chunked_attention(q, k, v, cfg)
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -9 * float(v.float().abs().max()) + \
        2.0 ** -8 * (got.float().abs() + want.float().abs()) + 1e-5
    assert bool((err <= bound).all()), float(err.max())


def test_flash_attention_on_card_is_the_round_p_kernel(dev):
    """``nn/attention.flash_attention`` on CUDA tensors launches the kernel
    in its round-once mode: within bound (i)
    (``swa_attention.round_p_tolerance``) of its plain version
    ``chunked_attention(..., chunk=64)`` run on the card, and closer to
    it (RMS) than the kernel's float32-p mode is."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import swa_attention as swa
    from repro_torch.launch.train import reduced_config
    from repro_torch.nn import attention
    cfg = reduced_config(get_config("mistral-nemo-12b")).with_(
        num_kv_heads=2, sliding_window=100)
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((2, 600, h, 64), generator=g).to(dev, torch.bfloat16)
               for h in (4, 2, 2))
    kernels.reset_launches()
    got = attention.flash_attention(q, k, v, cfg)
    assert kernels.LAUNCHES["swa_attention"] == 1
    want = attention.chunked_attention(q, k, v, cfg, chunk=swa.BK)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    tol = swa.round_p_tolerance(qh, kh, vh, 100, True, got.transpose(1, 2),
                                want.transpose(1, 2))
    err = (got.float() - want.float()).abs().transpose(1, 2)
    assert bool((err <= tol).all()), float((err / tol).max())
    f32p = ops.swa_attention(qh, kh, vh, window=100)
    rms = [float((a.float() - want.float()).pow(2).mean().sqrt())
           for a in (got, f32p.transpose(1, 2))]
    assert rms[0] < 0.5 * rms[1], rms


def test_flash_attention_non_causal_ignores_window(dev):
    """A non-causal call on the card ignores ``cfg.sliding_window``, as the
    reference's and the CPU path's do: it equals the window-0 call bit for
    bit, and the plain chunked version within the bound above."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.nn import attention
    cfg = reduced_config(get_config("mistral-nemo-12b")).with_(
        num_kv_heads=2, sliding_window=100)
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 300, h, 64), generator=g).to(dev, torch.bfloat16)
               for h in (4, 2, 2))
    got = attention.flash_attention(q, k, v, cfg, causal=False)
    full = attention.flash_attention(q, k, v, cfg.with_(sliding_window=0),
                                     causal=False)
    assert same_bits(got, full)
    want = attention.chunked_attention(q, k, v, cfg, causal=False)
    err = (got.float() - want.float()).abs()
    bound = 2.0 ** -9 * float(v.float().abs().max()) + \
        2.0 ** -8 * (got.float().abs() + want.float().abs()) + 1e-5
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.parametrize("softcap,q_offset", [(30.0, 0), (0.0, 64),
                                              (30.0, 64)])
def test_flash_attention_softcap_and_offset_on_card_match_cpu(dev, softcap,
                                                              q_offset):
    """A logit softcap or an offset q is outside what the kernel computes:
    ``flash_attention`` on CUDA tensors then runs ``chunked_attention``
    on the card, launching no kernel, and returns what the CPU path
    returns on the same float32 inputs, within float32 rounding (the
    card's and the host's GEMMs sum in other orders)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.train import reduced_config
    from repro_torch.nn import attention
    cfg = reduced_config(get_config("mistral-nemo-12b")).with_(
        num_kv_heads=2, sliding_window=100, attn_logit_softcap=softcap)
    g = torch.Generator().manual_seed(4)
    q = torch.randn((2, 200 - q_offset, 4, 64), generator=g)
    k, v = (torch.randn((2, 200, 2, 64), generator=g) for _ in range(2))
    kernels.reset_launches()
    got = attention.flash_attention(q.to(dev), k.to(dev), v.to(dev), cfg,
                                    q_offset=q_offset)
    assert kernels.LAUNCHES["swa_attention"] == 0
    want = attention.flash_attention(q, k, v, cfg, q_offset=q_offset)
    assert got.device.type == "cuda" and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_decoder_on_card_matches_cpu(dev):
    """Reduced NeMo with GQA in float32: forward logits on the card (the
    kernel) against the CPU (the chunked plain version), rtol / atol 1e-4
    (other summation orders, as in tests/test_torch_decoder_lm.py), and
    greedy tokens through a wrapped 16-slot ring equal."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import decoder_lm as dlm
    from repro_torch.nn.basic import tree_map
    cfg = reduced_config(get_config("mistral-nemo-12b")).with_(
        num_kv_heads=2, sliding_window=16)
    params = dlm.init_model(cfg, 0, device="cpu")
    on_card = tree_map(lambda x: x.to(dev), params)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 40)))
    kernels.reset_launches()
    got, _ = dlm.forward(on_card, cfg, toks.to(dev))
    assert kernels.LAUNCHES["swa_attention"] == cfg.num_layers
    want, _ = dlm.forward(params, cfg, toks)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    seq_card = serve.generate(on_card, cfg, toks[:, :8], 40, max_len=64,
                              device=dev)
    seq_cpu = serve.generate(params, cfg, toks[:, :8], 40, max_len=64,
                             device="cpu")
    assert torch.equal(seq_card.cpu(), seq_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(5120, 14336), (300, 200), (7, 130),
                                   (1000,), (64, 64, 3),
                                   # past 65,535 rows; a 1-D leaf past
                                   # 65,535 column tiles
                                   (70000, 64), (70_000 * 1024 + 5,)])
def test_seed_reconstruct_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import seed_reconstruct as sr
    rows, cols = ref.seed_dims(shape)
    b1, b2 = sr.seed_bits(42, 7, shape, device=dev)
    w1, w2 = ref.seed_bits_plain(42, 7, rows, cols, device=dev)
    assert torch.equal(b1, w1) and torch.equal(b2, w2)
    kernels.reset_launches()
    got = ops.seed_reconstruct(42, 7, shape, 0.02, dtype=dtype, device=dev)
    assert kernels.LAUNCHES["seed_reconstruct"] == 1
    want = ref.seed_reconstruct_plain(42, 7, shape, 0.02, dtype=dtype,
                                      device=dev)
    assert got.shape == tuple(shape) and got.dtype == dtype
    ulps = (got.float().view(torch.int32).long()
            - want.float().view(torch.int32).long()).abs().max()
    assert int(ulps) <= (8 if dtype == torch.float32 else 1 << 16)
    assert same_bits(ops.seed_reconstruct(42, 7, shape, 0.02, dtype=dtype,
                                          device=dev), got)

