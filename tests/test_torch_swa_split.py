"""The arithmetic of the tensor-core ``swa_attention`` kernel, on the CPU.

The kernel's default mode keeps p in float32 but multiplies it into V on
bf16 / fp16 tensor cores as two terms, ``ref.split_p``: p_hi = T(p), p_lo
= T(p - p_hi). These tests hold that split to its error bound, and a
dense emulation of the kernel's p.v (float32 scores and softmax, (sum p_hi
v + sum p_lo v) / l, rounded once to the input's type) to the card tests'
unchanged tolerance, HALF_ULP[dtype] * |want| + 1e-5 against
``ref.swa_attention_ref``. ``tile_plan``, the CPU twin of the tiles the
kernel reads and masks, is held against the dense mask.

The ``round_p`` mode keeps p_hi only: p rounded once to v's type, at the
running max of the kernel's 64-key tiles. :func:`emulate_round_p` is that
product with the kernel's float32 quantities rounded otherwise (sums in
float64, then rounded; a correctly rounded exp), and it is held against
the mode's plain version ``ref.chunked_attention_ref(..., chunk=64)``
within ``swa_attention.round_p_tolerance`` (bound (i), derived in its
docstring). Run as a script, this file prints how much of that bound
the emulation uses at the card tests' shapes.

Bounds. Each rounding to nearest is within half an ulp: 2**-8 relative
in bf16 (8 significant bits), 2**-11 in fp16 (11 bits). p - p_hi is exact
in float32 and at most 2**-8 p (bf16), so p_lo's rounding leaves
|p - p_hi - p_lo| <= 2**-16 p; in fp16 2**-22 p, plus half of fp16's
subnormal spacing (2**-25) where p or p - p_hi falls below fp16's normal
range; bf16 has float32's exponent range, so only float32 subnormals add
half of bf16's subnormal spacing (2**-134).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import swa_attention as swa

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:     # a pinned CI dependency; without it one test skips
    HAVE_HYPOTHESIS = False

HALF_ULP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
SPLIT_REL = {torch.bfloat16: 2.0 ** -16, torch.float16: 2.0 ** -22}
SPLIT_ABS = {torch.bfloat16: 2.0 ** -134, torch.float16: 2.0 ** -25}


def _probabilities(seed=0):
    """float32 p in [0, 1]: uniform draws, a log sweep down through fp16's
    subnormal range (below 2**-14) to float32's smallest normals, float32
    subnormals, and 0, 1 and values next to bf16 / fp16 rounding ties."""
    rng = np.random.default_rng(seed)
    ties = np.float32(1.0) + np.float32(2.0 ** -9) * np.arange(-4, 5)
    parts = [rng.random(20000, dtype=np.float32),
             np.float32(10.0) ** rng.uniform(-37.9, 0, 20000).astype(np.float32),
             np.float32(2.0) ** rng.uniform(-30, -14, 5000).astype(np.float32),
             (rng.random(1000, dtype=np.float32) * np.float32(2.0 ** -126)),
             np.array([0.0, 1.0], np.float32),
             np.clip(ties, 0, 1) * np.float32(0.75)]
    return torch.from_numpy(np.concatenate(parts).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_split_p_error_bound(dtype):
    p = _probabilities()
    hi, lo = ref.split_p(p, dtype)
    assert hi.dtype == dtype and lo.dtype == dtype
    # float64: the check itself must not round
    err = (p.double() - hi.double() - lo.double()).abs()
    bound = SPLIT_REL[dtype] * p.double() + SPLIT_ABS[dtype]
    assert bool((err <= bound).all()), float((err / bound).max())
    # the first term alone is one rounding: far outside the bound
    one = (p.double() - hi.double()).abs()
    assert float(one.max()) > 100 * float(bound[p > 0.5].max())


def emulate_kernel(q, k, v, window: int, causal: bool = True,
                   q_chunk: int = 256):
    """The tensor-core kernel's function, dense: float32 scores, softmax
    with float32 p and l = sum p, then (p_hi v + p_lo v) / l with float32
    sums of the exact products, rounded once to q's dtype."""
    B, H, S, D = q.shape
    rep = H // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    kpos = torch.arange(S)
    outs = []
    for q0 in range(0, S, q_chunk):
        qc = q[:, :, q0:q0 + q_chunk].float()
        qpos = q0 + torch.arange(qc.shape[2])
        mask = torch.ones((qc.shape[2], S), dtype=torch.bool)
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = torch.einsum("bhqd,bhkd->bhqk", qc, kf) * scale
        s = torch.where(mask, s, ref.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        hi, lo = ref.split_p(p, q.dtype)
        pv = (torch.einsum("bhqk,bhkd->bhqd", hi.float(), vf)
              + torch.einsum("bhqk,bhkd->bhqd", lo.float(), vf))
        outs.append((pv / p.sum(-1, keepdim=True)).to(q.dtype))
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("B,H,KVH,S,D,dtype", [
    (1, 4, 2, 300, 64, torch.bfloat16),      # GQA rep 2
    (1, 4, 1, 257, 100, torch.float16),      # rep 4, D below 128, ragged S
    (2, 4, 4, 200, 128, torch.bfloat16)])    # no GQA, two batches
def test_split_emulation_within_card_tolerance(B, H, KVH, S, D, dtype,
                                               window, causal):
    rng = np.random.default_rng(S + window + int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, D),
                                                    dtype=np.float32)).to(dtype)
               for h in (H, KVH, KVH))
    got = emulate_kernel(q, k, v, window, causal)
    want = ref.swa_attention_ref(q, k, v, window, causal)
    err = (got.float() - want).abs()
    tol = HALF_ULP[dtype] * want.abs() + 1e-5
    assert got.dtype == dtype
    assert bool((err <= tol).all()), float((err / tol).max())


def emulate_round_p(q, k, v, window: int, causal: bool = True,
                    bk: int = swa.BK):
    """The ``round_p`` kernel's function over ``bk``-key tiles: scores and
    sums of exact products taken in float64 and rounded to float32 (the
    tensor cores sum in another order than torch), p = exp(s - m) and the
    rescale correctly rounded, l summing the float32 p, acc += T(p) v;
    the output rounded once to q's dtype."""
    B, H, S, D = q.shape
    kd = ref._repeat_kv(k, H).double()
    vd = ref._repeat_kv(v, H).double()
    qd = q.double()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    m = torch.full((B, H, S), ref.NEG_INF)
    l = torch.zeros((B, H, S))
    acc = torch.zeros((B, H, S, D))
    qpos = torch.arange(S)
    for k0 in range(0, S, bk):
        kpos = k0 + torch.arange(min(bk, S - k0))
        s = torch.einsum("bhqd,bhkd->bhqk", qd,
                         kd[:, :, k0:k0 + bk]).float() * scale
        s = torch.where(ref._swa_mask(qpos, kpos, window, causal), s,
                        ref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp((s - m_new[..., None]).double()).float()
        corr = torch.exp((m - m_new).double()).float()
        l = l * corr + p.double().sum(-1).float()
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(q.dtype).double(),
            vd[:, :, k0:k0 + bk]).float()
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _round_p_case(B, H, KVH, S, D, dtype, window, causal):
    """(share of bound (i) used by the round-once emulation, its RMS
    distance to the oracle, the float32-p emulation's RMS distance)."""
    rng = np.random.default_rng(S + window + int(causal))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, h, S, D),
                                                    dtype=np.float32)).to(dtype)
               for h in (H, KVH, KVH))
    want = ref.chunked_attention_ref(q, k, v, window, causal, chunk=swa.BK)
    got = emulate_round_p(q, k, v, window, causal)
    assert got.dtype == dtype
    tol = swa.round_p_tolerance(q, k, v, window, causal, got, want)
    share = float(((got.float() - want.float()).abs() / tol).max())

    def rms(a):
        return float((a.float() - want.float()).pow(2).mean().sqrt())
    return share, rms(got), rms(emulate_kernel(q, k, v, window, causal))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 50])
@pytest.mark.parametrize("B,H,KVH,S,D,dtype", [
    (1, 4, 2, 300, 64, torch.bfloat16),      # GQA rep 2
    (1, 4, 1, 257, 100, torch.float16),      # rep 4, D below 128, ragged S
    (2, 4, 4, 200, 128, torch.bfloat16)])    # no GQA, two batches
def test_round_p_emulation_within_bound(B, H, KVH, S, D, dtype, window,
                                        causal):
    """Bound (i) holds for the round-once product, and the float32-p
    product lies several times farther from the round-once oracle (what
    the card tests' mode check relies on)."""
    share, rms_round, rms_f32p = _round_p_case(B, H, KVH, S, D, dtype,
                                               window, causal)
    assert share <= 1.0, share
    assert rms_round < 0.5 * rms_f32p, (rms_round, rms_f32p)


def _dense_mask(S, window, causal):
    qp = np.arange(S)[:, None]
    kp = np.arange(S)[None, :]
    mask = qp >= kp if causal else np.ones((S, S), bool)
    if window > 0:
        mask = mask & (qp - kp < window)
    return mask


def _check_plan(S, window, causal, bq, bk):
    mask = _dense_mask(S, window, causal)
    plan = swa.tile_plan(S, window, causal, bq, bk)
    assert len(plan) == -(-S // bq)
    pairs = 0
    for i, (first, last, masked) in enumerate(plan):
        rows = mask[i * bq:(i + 1) * bq]
        assert 0 <= first <= last < -(-S // bk)
        for t in range(-(-S // bk)):
            tile = rows[:, t * bk:(t + 1) * bk]
            if t < first or t > last:         # skipped: wholly invisible
                assert not tile.any(), (i, t)
                continue
            pairs += int(tile.sum())
            if t not in masked:               # unmasked: whole and visible
                assert tile.shape[1] == bk and tile.all(), (i, t)
    assert pairs == swa.visible_pairs(S, window, causal)


@pytest.mark.parametrize("S,window,causal", [
    (127, 0, True), (128, 0, True), (129, 1, True), (4000, 127, True),
    (4000, 128, True), (4000, 129, True), (300, 1000, True),
    (300, 0, False), (300, 70, False)])
def test_tile_plan_edges(S, window, causal):
    for bq in (64, swa.BQ):
        _check_plan(S, window, causal, bq, swa.BK)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="needs hypothesis")
def test_tile_plan_matches_dense_mask():
    @settings(max_examples=300, deadline=None)
    @given(S=st.integers(1, 700), window=st.integers(0, 800),
           causal=st.booleans(), bq=st.sampled_from([64, 128]),
           bk=st.sampled_from([64, 128]))
    def check(S, window, causal, bq, bk):
        _check_plan(S, window, causal, bq, bk)
    check()


if __name__ == "__main__":
    # the round-once emulation at the card tests' shapes
    # (tests/test_torch_kernels_cuda.py): share of bound (i) and RMS
    # distances to the oracle of the round-once and float32-p products
    for case in [(2, 8, 2, 1000, 100, torch.bfloat16),
                 (1, 4, 4, 257, 128, torch.float16),
                 (1, 32, 8, 4000, 128, torch.bfloat16)]:
        for window in (0, 100, 1000):
            for causal in (True, False):
                share, r, f = _round_p_case(*case, window, causal)
                print(f"{case[:5]} {str(case[5])[6:]} window {window} causal "
                      f"{causal}: {share:.3f} of bound (i); RMS to the "
                      f"oracle {r:.3e} (round-once) vs {f:.3e} (float32 p)",
                      flush=True)
