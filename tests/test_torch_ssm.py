"""The port's ``nn/ssm.py`` (Mamba, mLSTM, sLSTM) and the reduced
Jamba-v0.1 and xLSTM-350M against the JAX package, on the same numpy
inputs and the reference's own weights (carried across by the bridge).

Cells, at reduced widths with float32 compute (d_model 32, 2 heads,
d_state 4; mLSTM d_in 64, dh 32): each init's leaves; ``causal_conv1d``
and ``conv1d_step``; ``mamba_forward`` and its final (h, conv tail), at
S = 24 and at S = 300 (across ``MAMBA_CHUNK``); ``mamba_step`` rolled
over S against the forward; ``mlstm_forward`` at chunk sizes that divide
S and one that does not (the padding path); ``mlstm_step``;
``slstm_forward`` / ``slstm_step``; each cell's gradient through
``torch.func.grad`` (and under ``vmap``, the FedPT client step's form)
against ``jax.grad``; the mLSTM's gradient where the masked decay
overflows float32 (NaN in the reference); one bf16 case of
``_mlstm_qkvif`` whose k is scaled by the bf16 square root of dh = 512
(22.625). Models, on
``launch/train.reduced_config`` of each (d_model 256, 4 heads, vocab
512, float32 compute; Jamba 8 layers with 4 experts, xLSTM 4): the
``forward`` caches, 6 decode steps with every cache entry's shape, dtype
and value, decode against ``forward``, greedy ``generate`` and the
serving split (their 2-round ``run_reduced_arch`` histories are in
``tests/test_torch_ssm_history.py``).

Tolerances. Init: A_log (XLA's float32 log, ``ssm.log_f32``), zeros and
ones exact, normals within 4 ulps (the threefry bits are JAX's; torch's
and XLA's erfinv round differently, ``tests/test_torch_prng.py``). The
cells sum 4- to 64-long float32 products in other orders than XLA and
run recurrences of up to 300 steps: rtol / atol 1e-4 (the zoo's), each
gradient leaf within 1e-4 of its largest |entry| (the zoo's GRAD_REL).
A rolled step against the forward: 2e-5 (``tests/test_ssm.py``'s bound,
3e-5 for the chunkwise mLSTM). Decode against ``forward``: 2e-4 (the
zoo's). Greedy tokens are equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch.train import reduced_config as jreduced
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro.nn import ssm as jssm
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic
from repro_torch.nn import ssm as tssm

RTOL = ATOL = 1e-4
GRAD_REL = 1e-4
ULPS = 4
STEP_TOL = 2e-5
CONSIST_TOL = 2e-4
ARCHS = ["jamba-v0.1-52b", "xlstm-350m"]

CELL = dict(name="s", family="ssm", num_layers=1, d_model=32, num_heads=2,
            num_kv_heads=2, d_ff=0, vocab_size=8, compute_dtype="float32",
            mamba_d_state=4, mamba_expand=2)
JCFG = JModelConfig(**CELL)
TCFG = tbase.ModelConfig(**CELL)
INIT = {"mamba": (jssm.init_mamba, tssm.init_mamba),
        "mlstm": (jssm.init_mlstm, tssm.init_mlstm),
        "slstm": (jssm.init_slstm, tssm.init_slstm)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_torch(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


def _rand(seed, *shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape, dtype=np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _cell(kind):
    """(JAX leaves, the port's copy) of one cell at the reduced widths."""
    jp = INIT[kind][0](3, f"c/{kind}", JCFG, jnp.float32)
    return jp, _to_torch(jp)


# --- cells ------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(INIT))
def test_init_leaves_match_jax(kind):
    jinit, tinit = INIT[kind]
    want = dict(jbasic.flatten_params(jinit(3, f"c/{kind}", JCFG,
                                            jnp.float32)))
    got = dict(tbasic.flatten_params(tinit(3, f"c/{kind}", TCFG,
                                           torch.float32, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == np.float32, path
        exact = path in ("A_log", "D") or "norm" in path or \
            path.endswith(("bias", "conv_b"))
        assert _ulps(g, w) <= (0 if exact else ULPS), path
    if kind == "slstm":
        assert got["up_gate/kernel"].shape == (32, tssm.slstm_up_width(32))
        assert tssm.slstm_up_width(1024) == 1364


def test_log_f32_is_xlas_log_at_the_a_log_arguments():
    n = np.arange(1, 4097)
    np.testing.assert_array_equal(tssm.log_f32(n),
                                  np.asarray(jnp.log(n.astype(np.float32))))
    # a correctly rounded log differs at 7 (XLA's is one ulp above)
    assert tssm.log_f32(np.array([7]))[0] != np.float32(np.log(7.0))


def test_causal_conv1d_and_step_match_jax():
    x, w, b = _rand(0, 2, 9, 6), _rand(1, 4, 6), _rand(2, 6, scale=0.1)
    want = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    got = tssm.causal_conv1d(tx, tw, tb)
    _close(got, want)
    state = torch.zeros((2, 3, 6))
    jstate = jnp.zeros((2, 3, 6))
    outs = []
    for t in range(9):
        y, state = tssm.conv1d_step(tx[:, t], state, tw, tb)
        jy, jstate = jssm.conv1d_step(jnp.asarray(x[:, t]), jstate,
                                      jnp.asarray(w), jnp.asarray(b))
        _close(y, jy)
        outs.append(y)
    _close(torch.stack(outs, 1), want, STEP_TOL, STEP_TOL)
    _close(state, jstate)


@pytest.mark.parametrize("S", [24, 300])
def test_mamba_forward_and_final_state_match_jax(S):
    """S = 300 crosses ``MAMBA_CHUNK`` (256): dA / dBx are made a chunk at
    a time, the reference's whole."""
    jp, tp = _cell("mamba")
    x = _rand(4, 2, S, 32)
    jout, (jh, jtail) = jssm.mamba_forward(jnp.asarray(x), jp, JCFG)
    out, (h, tail) = tssm.mamba_forward(torch.from_numpy(x), tp, TCFG)
    assert tuple(h.shape) == (2, 64, 4) and tuple(tail.shape) == (2, 3, 64)
    assert h.dtype == torch.float32
    for g, w in ((out, jout), (h, jh), (tail, jtail)):
        _close(g, w)


def test_mamba_step_rolled_matches_forward():
    jp, tp = _cell("mamba")
    x = torch.from_numpy(_rand(5, 2, 10, 32))
    full, (h_fin, tail) = tssm.mamba_forward(x, tp, TCFG)
    state = (torch.zeros((2, 64, 4)), torch.zeros((2, 3, 64)))
    jstate = (jnp.zeros((2, 64, 4)), jnp.zeros((2, 3, 64)))
    outs = []
    for t in range(10):
        y, state = tssm.mamba_step(x[:, t], tp, TCFG, state)
        jy, jstate = jssm.mamba_step(jnp.asarray(x[:, t].numpy()), jp, JCFG,
                                     jstate)
        _close(y, jy)
        outs.append(y)
    _close(torch.stack(outs, 1), full.numpy(), STEP_TOL, STEP_TOL)
    _close(state[0], h_fin.numpy(), STEP_TOL, STEP_TOL)
    _close(state[1], tail.numpy(), 0, 0)
    for g, w in zip(state, jstate):
        _close(g, w)


@pytest.mark.parametrize("chunk", [8, 10, 128])
def test_mlstm_forward_matches_jax(chunk):
    """A chunk of 8 divides S = 24; 10 and 128 (the model's) do not (the
    padding path, log_i = -30)."""
    jp, tp = _cell("mlstm")
    x = _rand(6, 2, 24, 32)
    state = (_rand(7, 2, 2, 32, 32, scale=0.1), _rand(8, 2, 2, 32, scale=0.1))
    for st in (None, state):
        jout, (jC, jn) = jssm.mlstm_forward(
            jnp.asarray(x), jp, JCFG, chunk=chunk,
            state=None if st is None else tuple(map(jnp.asarray, st)))
        out, (C, n) = tssm.mlstm_forward(
            torch.from_numpy(x), tp, TCFG, chunk=chunk,
            state=None if st is None else tuple(map(torch.from_numpy, st)))
        assert tuple(C.shape) == (2, 2, 32, 32)
        assert tuple(n.shape) == (2, 2, 32)
        for g, w in ((out, jout), (C, jC), (n, jn)):
            _close(g, w)


def test_mlstm_step_matches_jax_and_forward():
    jp, tp = _cell("mlstm")
    x = torch.from_numpy(_rand(9, 2, 20, 32))
    full, (Cf, nf) = tssm.mlstm_forward(x, tp, TCFG, chunk=8)
    state = (torch.zeros((2, 2, 32, 32)), torch.zeros((2, 2, 32)),
             torch.zeros((2, 3, 64)))
    jstate = tuple(jnp.asarray(t.numpy()) for t in state)
    outs = []
    for t in range(20):
        y, state = tssm.mlstm_step(x[:, t], tp, TCFG, state)
        jy, jstate = jssm.mlstm_step(jnp.asarray(x[:, t].numpy()), jp, JCFG,
                                     jstate)
        _close(y, jy)
        outs.append(y)
    for g, w in zip(state, jstate):
        _close(g, w)
    _close(torch.stack(outs, 1), full.numpy(), 3e-5, 3e-5)
    _close(state[0], Cf.numpy(), 3e-5, 3e-5)
    _close(state[1], nf.numpy(), 3e-5, 3e-5)


def test_slstm_forward_and_step_match_jax():
    jp, tp = _cell("slstm")
    x = _rand(10, 2, 16, 32)
    jout, jst = jssm.slstm_forward(jnp.asarray(x), jp, JCFG)
    out, st = tssm.slstm_forward(torch.from_numpy(x), tp, TCFG)
    _close(out, jout)
    for g, w in zip(st, jst):
        assert tuple(g.shape) == (2, 2, 16)
        _close(g, w)
    zeros = torch.zeros((2, 2, 16))
    cell = (zeros, zeros, zeros, zeros - 30.0)
    state = (cell, torch.zeros((2, 3, 32)))
    jstate = (tuple(jnp.asarray(t.numpy()) for t in cell),
              jnp.zeros((2, 3, 32)))
    outs = []
    for t in range(16):
        y, state = tssm.slstm_step(torch.from_numpy(x[:, t]), tp, TCFG, state)
        jy, jstate = jssm.slstm_step(jnp.asarray(x[:, t]), jp, JCFG, jstate)
        _close(y, jy)
        outs.append(y)
    _close(torch.stack(outs, 1), out.numpy(), STEP_TOL, STEP_TOL)
    for g, w in zip(state[0], st):
        _close(g, w.numpy(), STEP_TOL, STEP_TOL)


def _jfwd(kind):
    return {"mamba": jssm.mamba_forward, "mlstm": jssm.mlstm_forward,
            "slstm": jssm.slstm_forward}[kind]


def _tfwd(kind):
    return {"mamba": tssm.mamba_forward, "mlstm": tssm.mlstm_forward,
            "slstm": tssm.slstm_forward}[kind]


_JGRADS = {}


@pytest.mark.parametrize("vmapped", [False, True])
@pytest.mark.parametrize("kind", sorted(INIT))
def test_cell_gradients_match_jax(kind, vmapped):
    """grad of <out, r> into the cell's leaves and the input, S = 20; with
    ``vmapped`` the port's gradient is taken under ``torch.func.vmap``
    over 2 clients of one row each (the round engine's form)."""
    jp, tp = _cell(kind)
    x, r = _rand(11, 2, 20, 32), _rand(12, 2, 20, 32)
    if kind not in _JGRADS:   # JAX's side once for both port forms
        _JGRADS[kind] = jax.grad(
            lambda p, x: jnp.sum(_jfwd(kind)(x, p, JCFG)[0] * jnp.asarray(r)),
            argnums=(0, 1))(jp, jnp.asarray(x))
    jg = _JGRADS[kind]

    def tloss(p, x, r):
        return (_tfwd(kind)(x, p, TCFG)[0] * r).sum()
    args = (torch.from_numpy(x), torch.from_numpy(r))
    if vmapped:
        per = torch.func.vmap(torch.func.grad(
            lambda p, x, r: tloss(p, x[None], r[None]), argnums=(0, 1)),
            in_dims=(None, 0, 0))(tp, *args)
        tg = (tbasic.tree_map(lambda t: t.sum(0), per[0]), per[1])
    else:
        tg = torch.func.grad(tloss, argnums=(0, 1))(tp, *args)
    want = dict(jbasic.flatten_params(jg[0]))
    got = dict(tbasic.flatten_params(tg[0]))
    assert sorted(got) == sorted(want)
    for path, w in list(want.items()) + [("x", jg[1])]:
        w = np.asarray(w)
        g = (tg[1] if path == "x" else got[path]).numpy()
        err = np.abs(g - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_mlstm_gradient_stays_finite_where_the_masked_decay_overflows():
    """Forget-gate biases of -12 make F_t - F_s + li_s pass float32's exp
    range above the diagonal of a 24-position chunk (~12 a position, 276
    at most): the reference's gradient through where(tri, exp(Dlog), 0)
    is NaN there (0 * inf), the port's (the exp of the masked log-decay)
    is finite and equals JAX's at chunk 6, where no decay overflows (the
    chunkwise form does not depend on the chunk)."""
    jp, tp = _cell("mlstm")
    bias = np.array([0.0, 0.0, -12.0, -12.0], np.float32)   # (log_i, f_pre)
    jp = dict(jp, w_if=dict(jp["w_if"], bias=jnp.asarray(bias)))
    tp = dict(tp, w_if=dict(tp["w_if"], bias=torch.from_numpy(bias)))
    x, r = _rand(14, 2, 24, 32), _rand(15, 2, 24, 32)

    def jgrad(chunk):
        return jax.grad(lambda p: jnp.sum(jssm.mlstm_forward(
            jnp.asarray(x), p, JCFG, chunk=chunk)[0] * jnp.asarray(r)))(jp)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree_util.tree_leaves(jgrad(24)))
    want = dict(jbasic.flatten_params(jgrad(6)))
    got = dict(tbasic.flatten_params(torch.func.grad(
        lambda p: (tssm.mlstm_forward(torch.from_numpy(x), p, TCFG,
                                      chunk=24)[0]
                   * torch.from_numpy(r)).sum())(tp)))
    for path, w in want.items():
        w = np.asarray(w)
        assert np.isfinite(w).all() and torch.isfinite(got[path]).all(), path
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_mlstm_qkvif_scales_k_by_the_bf16_square_root():
    """bf16 compute at dh = 512 (d_model 256, 1 head, d_in 512): k is
    divided by sqrt(512) taken in bf16, 22.625 (22.627 in float32), as the
    reference's ``k / jnp.sqrt(jnp.asarray(dh, cd))``."""
    kw = dict(CELL, d_model=256, num_heads=1, compute_dtype="bfloat16")
    jcfg, tcfg = JModelConfig(**kw), tbase.ModelConfig(**kw)
    assert tssm.xlstm_dims(tcfg) == (512, 1, 512)
    jp = jssm.init_mlstm(3, "m", jcfg, jnp.float32)
    tp = _to_torch(jp)
    x = _rand(13, 1, 6, 256)
    jq, jk, *_ = jssm._mlstm_qkvif(jnp.asarray(x), jp, jcfg)
    q, k, v, log_i, log_f, z = tssm._mlstm_qkvif(torch.from_numpy(x), tp,
                                                  tcfg)
    assert k.dtype == q.dtype == torch.bfloat16
    assert log_i.dtype == torch.float32
    sq = tssm._sqrt_dh(512, torch.bfloat16, k.device)
    assert float(sq) == 22.625 == float(np.asarray(
        jnp.sqrt(jnp.asarray(512, jnp.bfloat16)), np.float32))
    # k is the bf16 projection divided by the bf16 22.625, not by 22.627
    raw = tbasic.dense(torch.nn.functional.silu(tssm.causal_conv1d(
        tbasic.dense(torch.from_numpy(x), tp["up_proj"], torch.bfloat16)[
            ..., :512], tp["conv_w"].bfloat16(), tp["conv_b"].bfloat16())),
        tp["wk"], torch.bfloat16).reshape(1, 6, 1, 512).transpose(1, 2)
    assert torch.equal(k, raw / sq)
    assert not torch.equal(k, (raw.float() / np.sqrt(512.0)).bfloat16())
    # against the reference's k: bf16 projections, a bf16 ulp or two apart
    _close(k, np.asarray(jk, np.float32), 2e-2, 2e-2)
    _close(q, np.asarray(jq, np.float32), 2e-2, 2e-2)


# --- the reduced Jamba and xLSTM ---------------------------------------------


def _cfgs(arch, **kw):
    jcfg = jreduced(jget(arch)).with_(**kw)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        jp = jdlm.init_model(_cfgs(arch)[0], 0)
        _PARAMS[arch] = (jp, _to_torch(jp))
    return _PARAMS[arch]


def test_configs_are_the_references():
    for arch in ARCHS:
        full = tbase.get_config(arch)
        assert dataclasses.asdict(full) == dataclasses.asdict(jget(arch))
    jamba = tdlm.layer_program(tbase.get_config("jamba-v0.1-52b"))
    assert [s.kind for s in jamba[0]] == ["mamba"] * 4 + ["attn"] + \
        ["mamba"] * 3 and jamba[1] == 4
    assert [s.use_moe for s in jamba[0]] == [False, True] * 4
    xlstm = tdlm.layer_program(tbase.get_config("xlstm-350m"))
    assert [s.kind for s in xlstm[0]] == ["mlstm"] * 3 + ["slstm"]
    assert xlstm[1] == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_caches_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(1, 2, 20)
    jl, _, jc = jdlm.forward(jp, jcfg, jnp.asarray(toks), return_caches=True)
    tl, _, tc = tdlm.forward(tp, tcfg, torch.from_numpy(toks),
                             return_caches=True)
    _close(tl, jl)
    assert len(tc) == len(jc)
    for tentry, jentry in zip(tc, jc):
        assert len(tentry) == len(jentry)
        for g, w in zip(tentry, jentry):
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(
                w.dtype), (g.shape, g.dtype, w.shape, w.dtype)
            _close(g, w)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes_and_dtypes_are_the_references(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    if dtype:
        jcfg, tcfg = jcfg.with_(compute_dtype=dtype), \
            tcfg.with_(compute_dtype=dtype)
    want = jdlm.init_cache(jcfg, 3, 10)
    got = tdlm.init_cache(tcfg, 3, 10, device="cpu")
    assert sorted(got["slots"]) == sorted(want["slots"])
    for slot, entry in got["slots"].items():
        assert sorted(entry) == sorted(want["slots"][slot])
        for name, t in entry.items():
            w = want["slots"][slot][name]
            assert tuple(t.shape) == w.shape, (slot, name)
            assert str(t.dtype)[6:] == str(w.dtype), (slot, name)
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(w, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_jax(arch):
    """6 decode steps: each step's logits and every cache entry against
    JAX's decode; the recurrent states are written in place."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(2, 2, 6)
    jcache = jdlm.init_cache(jcfg, 2, 8)
    tcache = tdlm.init_cache(tcfg, 2, 8, device="cpu")
    held = {(s, n): t for s, e in tcache["slots"].items()
            for n, t in e.items()}
    jstep = jax.jit(lambda p, c, tok: jdlm.decode_step(p, jcfg, c, tok))
    for t in range(6):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tdlm.decode_step(tp, tcfg, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl)
    assert tcache["cache_len"] == int(jcache["cache_len"]) == 6
    for slot, entry in tcache["slots"].items():
        for name, t in entry.items():
            assert t is held[(slot, name)]
            w = jcache["slots"][slot][name]
            assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(
                w.dtype)
            _close(t, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_agrees_with_forward(arch, monkeypatch):
    """Step by step through 20 prompt positions against the teacher-forced
    ``forward`` (capacity factor 8.0: no token drops), at an mLSTM chunk
    of 8, so that decode crosses two chunk boundaries of the forward."""
    tcfg = _cfgs(arch, moe_capacity_factor=8.0)[1]
    _, tp = _params(arch)
    prompt = torch.from_numpy(_tokens(3, 2, 20))
    stepped, cache = tserve.prefill_by_steps(tp, tcfg, prompt, 24,
                                             device="cpu")
    real = tssm.mlstm_forward
    monkeypatch.setattr(tssm, "mlstm_forward",
                        lambda *a, **kw: real(*a, **kw, chunk=8))
    full, _ = tdlm.forward(tp, tcfg, prompt)
    assert cache["cache_len"] == 20
    _close(stepped, full.numpy(), CONSIST_TOL, CONSIST_TOL)


def test_xlstm_bf16_decode_gap_within_the_references():
    """xLSTM in bf16 compute: the step-by-step decode differs from the
    teacher-forced ``forward`` by one-ulp flips that each sLSTM block
    grows (1.4e-1 of the largest |logit| at full width on an H100,
    ``chip_smoke.py``'s phase 9). The reference has the same gap: run its own decode against
    its own forward on the reduced xLSTM's weights and prompt, and hold
    the port's gap to at most twice the reference's, plus 1e-3 of the
    largest |logit|."""
    jcfg, tcfg = _cfgs("xlstm-350m", compute_dtype="bfloat16")
    jp, tp = _params("xlstm-350m")
    toks = _tokens(5, 2, 24)

    def gap(stepped, full):
        stepped, full = (np.asarray(a, np.float32) for a in (stepped, full))
        return float(np.abs(stepped - full).max() / np.abs(full).max())
    jfull, _ = jdlm.forward(jp, jcfg, jnp.asarray(toks))
    jstep = jax.jit(lambda c, t: jdlm.decode_step(jp, jcfg, c, t))
    cache, jsteps = jdlm.init_cache(jcfg, 2, 24), []
    for t in range(24):
        lg, cache = jstep(cache, jnp.asarray(toks[:, t:t + 1]))
        jsteps.append(np.asarray(lg.astype(jnp.float32)))
    ref_gap = gap(np.concatenate(jsteps, 1), jfull.astype(jnp.float32))
    tfull, _ = tdlm.forward(tp, tcfg, torch.from_numpy(toks))
    tsteps, _ = tserve.prefill_by_steps(tp, tcfg, toks, 24, device="cpu")
    port_gap = gap(tsteps.float().numpy(), tfull.float().numpy())
    print(f"xLSTM bf16 decode vs forward: port {port_gap:.3e}, reference "
          f"{ref_gap:.3e} of the largest |logit|")
    assert port_gap <= 2 * ref_gap + 1e-3, (port_gap, ref_gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    prompt = _tokens(4, 2, 6)
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompt), 6))
    got = tserve.generate(tp, tcfg, prompt, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_split_consumes_the_frozen_leaves():
    """``serving_split`` takes each frozen leaf out of the tree it is
    given as its bf16 copy is made (the same bits as a copy of the whole
    half); the trainable leaves stay. The full-width shapes-only split of
    xLSTM-350M (``chip_smoke.py`` asserts Jamba-v0.1's on the card)."""
    tcfg = _cfgs("jamba-v0.1-52b")[1]
    _, tp = _params("jamba-v0.1-52b")
    tree = tbasic.tree_map(lambda x: x, tp)
    y, z = tspecs.serving_split(tree, tcfg)
    frozen = {p for p, _ in tbasic.flatten_params(z)}
    assert "layers/slot0/mamba/in_proj/kernel" in frozen
    assert "layers/slot1/moe/wi_gate" in frozen
    assert "layers/slot4/ffn/wo/kernel" in frozen
    left = dict(tbasic.flatten_params(tree))
    assert not frozen & set(left)
    assert set(left) == {p for p, _ in tbasic.flatten_params(y)}
    flat = dict(tbasic.flatten_params(tp))
    for path, t in tbasic.flatten_params(z):
        assert t.dtype == torch.bfloat16
        assert torch.equal(t, flat[path].to(torch.bfloat16)), path
    for path, t in tbasic.flatten_params(y):
        assert t is flat[path] and t is left[path]
    ys, zs = tspecs.param_structs(tbase.get_config("xlstm-350m"))
    assert (tbasic.tree_size(ys), tbasic.tree_size(zs)) == (
        77_390_992, 448_562_320 - 77_390_992)
