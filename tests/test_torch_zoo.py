"""The port's model zoo against the JAX package, on each ported assigned
architecture's ``reduced_config`` (2 layers, d_model 256, 4 heads, vocab
512, at most 4 experts, float32 compute): configs, the stacked init,
``forward`` logits and the MoE aux loss, ``train_loss`` and its gradient
into the trainable tree, and one federated step; for Mixtral also decode
against JAX's decode (capacity 1.25, drops included), decode against
``forward`` at capacity 8.0, 24 steps through an 8-slot ring,
``run_reduced_arch`` for 2 rounds and the training CLI.

Tolerances. Init: zeros exact, normals within 4 ulps (the threefry bits
are JAX's; torch's and XLA's erfinv round differently, as
``tests/test_torch_prng.py`` establishes). Outputs are computed from the
reference's own weights (carried across by the bridge) in float32; the
two packages sum 256- to 1024-long dot products in other orders, so
logits and losses of O(1) agree to rtol 1e-4 / atol 1e-4, each leaf's
gradient within 1e-4 of its largest |entry|. Decode at capacity 1.25
drops tokens, so it is held only against JAX's decode (routing near-ties
would show as a large difference; none occurs on these inputs).
Training: the two runs' losses within rel 1e-4 and the trained y by
update norm, ||dy_port - dy_jax|| <= 1e-3 ||dy_jax|| (two rounds of
float32 reassociation compound through SGD steps; measured ~1e-6).
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.configs import ARCH_IDS as JARCH_IDS, load_all
from repro.configs.base import get_config as jget
from repro.configs.base import list_configs as jlist
from repro.launch.train import reduced_config as jreduced
from repro.launch.train import run_reduced_arch as jrun_reduced_arch
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

load_all()
ARCHS = ["mixtral-8x7b", "qwen2.5-3b", "glm4-9b", "stablelm-1.6b"]
WAITING = ["deepseek-v2-236b", "jamba-v0.1-52b", "paligemma-3b",
           "xlstm-350m", "whisper-large-v3"]
RTOL = ATOL = 1e-4
GRAD_REL = 1e-4
ULPS = 4
UPDATE_REL = 1e-3


def _cfgs(arch, **kw):
    jcfg = jreduced(jget(arch)).with_(**kw)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


_PARAMS = {}


def _params(arch):
    """(JAX params, the port's copy of them) of the arch's reduced config,
    made once per module."""
    if arch not in _PARAMS:
        jp = jdlm.init_model(_cfgs(arch)[0], 0)
        _PARAMS[arch] = (jp, _to_torch(jp))
    return _PARAMS[arch]


def _tokens(seed, vocab, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def test_registry_matches_the_reference():
    assert tconfigs.ARCH_IDS == JARCH_IDS
    ported = tbase.list_configs()
    assert sorted(ported) == sorted(ARCHS + ["mistral-nemo-12b"])
    for name, cfg in ported.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jlist()[name])
    assert sorted(WAITING + list(ported)) == sorted(JARCH_IDS)


@pytest.mark.parametrize("arch", WAITING)
def test_waiting_architectures_name_their_module(arch):
    with pytest.raises(KeyError, match=re.escape(tbase.WAITING[arch])):
        tbase.get_config(arch)
    assert arch in JARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    full = jget(arch)
    tcfg = tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(full)
    assert dataclasses.asdict(ttrain.reduced_config(tcfg)) \
        == dataclasses.asdict(jreduced(full))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaves_match_jax(arch):
    jp, _ = _params(arch)
    got = dict(tbasic.flatten_params(
        tdlm.init_model(_cfgs(arch)[1], 0, device="cpu")))
    want = dict(jbasic.flatten_params(jp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        assert _ulps(g.numpy(), w) <= ULPS, path
        if "/ln" in path or "norm" in path or path.endswith("/bias"):
            assert not g.any(), path
    jcfg = _cfgs(arch)[0]
    if jcfg.num_experts:
        assert got["layers/slot0/moe/wi_gate"].shape == (2, 4, 256, 512)
    assert ("unembed/kernel" in got) != jcfg.tie_embeddings


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(1, jcfg.vocab_size, 2, 24)
    jl, jm = jdlm.forward(jp, jcfg, jnp.asarray(toks))
    tl, tm = tdlm.forward(tp, tcfg, torch.from_numpy(toks))
    _close(tl, jl)
    assert tm["moe_aux_loss"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["moe_aux_loss"]),
                               float(jm["moe_aux_loss"]), rtol=1e-5)
    assert (float(tm["moe_aux_loss"]) > 0) == bool(jcfg.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradient_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    toks = _tokens(2, jcfg.vocab_size, 2, 24)
    mask = (np.arange(24)[None, :] < np.array([[24], [17]])).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "mask": torch.from_numpy(mask)}
    jy, jz = jpart.partition(jp, jcfg.freeze_spec)
    ty, tz = tpart.partition(tp, tcfg.freeze_spec)
    assert tpart.count_params(tz) > 0
    jv, jg = jax.value_and_grad(
        lambda y: jdlm.train_loss(jpart.merge(y, jz), jcfg, jb)[0])(jy)
    tg, tv = torch.func.grad_and_value(
        lambda y: tdlm.train_loss(tpart.merge(y, tz), tcfg, tb)[0])(ty)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    want = dict(jbasic.flatten_params(jg))
    got = dict(tbasic.flatten_params(tg))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_train_loss_takes_the_chunked_attention(monkeypatch):
    """``train_loss`` passes ``chunked_attention`` explicitly: with
    ``flash_attention`` unusable it still runs, while ``forward``'s
    default (the serving prefill's) reaches ``flash_attention``."""
    from repro_torch.nn import attention as tattn
    _, tcfg = _cfgs("mixtral-8x7b")
    _, tp = _params("mixtral-8x7b")
    toks = torch.from_numpy(_tokens(7, tcfg.vocab_size, 1, 8))

    def refuse(*args, **kw):
        raise RuntimeError("flash_attention called")
    monkeypatch.setattr(tattn, "flash_attention", refuse)
    loss, _ = tdlm.train_loss(tp, tcfg, {"tokens": toks, "labels": toks})
    assert torch.isfinite(loss)
    with pytest.raises(RuntimeError, match="flash_attention called"):
        tdlm.forward(tp, tcfg, toks)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_federated_train_step(arch):
    """Port of ``tests/test_smoke_archs.py``'s train step: one round of 2
    clients x 1 step x batch 2 through the port's round engine, its loss
    against the JAX engine's, y moved, the frozen tree untouched."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(arch)
    y, frozen = tpart.partition(tp, tcfg.freeze_spec)
    frozen0 = tbasic.tree_map(torch.clone, frozen)
    toks = _tokens(3, jcfg.vocab_size, 2, 1, 2, 16)
    rc = tfedpt.RoundConfig(2, 1, 2, "sgd", 0.05, "sgd", 1.0)
    round_fn, sopt = tfedpt.make_round_fn(
        lambda p, mb: tdlm.train_loss(p, tcfg, mb), rc, device="cpu")
    y2, _, m = round_fn(y, sopt.init(y), frozen,
                        {"tokens": toks, "labels": toks},
                        np.ones((2,), np.float32))
    assert np.isfinite(float(m["loss"]))
    moved = sum(float((a - b).abs().sum()) for a, b in
                zip(tbasic.tree_leaves(y2), tbasic.tree_leaves(y)))
    assert moved > 0.0
    for a, b in zip(tbasic.tree_leaves(frozen), tbasic.tree_leaves(frozen0)):
        assert torch.equal(a, b)
    from repro.core import fedpt as jfedpt
    jy, jz = jpart.partition(jp, jcfg.freeze_spec)
    jround, jsopt = jfedpt.make_round_fn(
        lambda p, mb: jdlm.train_loss(p, jcfg, mb),
        jfedpt.RoundConfig(2, 1, 2, "sgd", 0.05, "sgd", 1.0))
    _, _, jm = jround(jy, jsopt.init(jy), jz,
                      {"tokens": jnp.asarray(toks),
                       "labels": jnp.asarray(toks)},
                      jnp.ones((2,), jnp.float32), jax.random.key(0))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=RTOL)
    np.testing.assert_allclose(float(m["delta_norm"]),
                               float(jm["delta_norm"]), rtol=1e-3)


# --- Mixtral: decode, the ring, training end to end ------------------------


def _decode_both(jcfg, tcfg, jp, tp, toks, max_len):
    """Step both packages' decode through toks (B, T); returns the per-step
    logits (B, T, V) of each."""
    B, T = toks.shape
    jcache = jdlm.init_cache(jcfg, B, max_len)
    tcache = tdlm.init_cache(tcfg, B, max_len, device="cpu")
    jout, tout = [], []
    for t in range(T):
        jl, jcache = jdlm.decode_step(jp, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tdlm.decode_step(tp, tcfg, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        jout.append(np.asarray(jl[:, 0]))
        tout.append(tl[:, 0])
    assert tcache["cache_len"] == int(jcache["cache_len"]) == T
    return np.stack(jout, 1), torch.stack(tout, 1), jcache, tcache


def test_mixtral_decode_matches_jax_with_drops(monkeypatch):
    """Capacity 1.25 at decode: T = B = 4 tokens a step over the reduced
    config's 4 experts give cap = round(2.5) = 2 slots an expert, so a
    step drops the tokens past an expert's second, as the reference does
    (the dropped entries are counted)."""
    from repro_torch.nn import moe as tmoe
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    assert jcfg.moe_capacity_factor == 1.25
    assert tmoe.capacity(4, tcfg) == 2
    jp, tp = _params("mixtral-8x7b")
    dropped = []
    real = tmoe._sort_dispatch

    def counting(*args):
        buf, meta = real(*args)
        dropped.append(int((~meta[1]).sum()))
        return buf, meta
    monkeypatch.setattr(tmoe, "_sort_dispatch", counting)
    toks = _tokens(4, jcfg.vocab_size, 4, 12)
    jl, tl, jc, tc = _decode_both(jcfg, tcfg, jp, tp, toks, 16)
    print(f"decode at capacity 1.25: {sum(dropped)} of "
          f"{len(dropped) * 8} routed entries dropped")
    assert len(dropped) == 24 and sum(dropped) > 0
    _close(tl, jl)
    for slot, entry in tc["slots"].items():
        for name in ("k", "v"):
            _close(entry[name], jc["slots"][slot][name])


def test_mixtral_decode_matches_forward_at_high_capacity():
    """Port of ``tests/test_system.py``'s ``t-moe`` case: token-by-token
    decode reproduces the teacher-forced forward where no token drops."""
    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
              d_ff=128, vocab_size=64, compute_dtype="float32",
              name="t-moe", family="moe", num_experts=4,
              num_experts_per_tok=2, moe_capacity_factor=8.0)
    cfg = tbase.ModelConfig(**kw)
    p = tdlm.init_model(cfg, 0, device="cpu")
    toks = _tokens(5, 64, 2, 8)
    cache = tdlm.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(8):
        lg, cache = tdlm.decode_step(p, cfg, cache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        outs.append(lg[:, 0])
    full, _ = tdlm.forward(p, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=2e-4)


def test_mixtral_decode_through_a_wrapped_ring():
    """24 steps at window 8 with max_len 32: an 8-slot ring that wraps
    twice; every step's logits and the final caches against JAX's."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", sliding_window=8)
    jp, tp = _params("mixtral-8x7b")
    assert tdlm.cache_capacity(tcfg, 32) == jdlm.cache_capacity(jcfg, 32) == 8
    toks = _tokens(6, jcfg.vocab_size, 2, 24)
    jl, tl, jc, tc = _decode_both(jcfg, tcfg, jp, tp, toks, 32)
    _close(tl, jl)
    for slot, entry in tc["slots"].items():
        assert tuple(entry["k"].shape) == (2, 2, 8, 4, 64)
        for name in ("k", "v"):
            _close(entry[name], jc["slots"][slot][name])


@pytest.fixture(scope="module")
def mixtral_runs():
    jres, jcfg = jrun_reduced_arch("mixtral-8x7b", 2, log=False)
    tres, tcfg = ttrain.run_reduced_arch("mixtral-8x7b", 2, log=False,
                                         device="cpu")
    return jres, jcfg, tres, tcfg


def test_run_reduced_arch_matches_the_reference(mixtral_runs):
    jres, jcfg, tres, tcfg = mixtral_runs
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jl = [h["loss"] for h in jres.history]
    tl = [h["loss"] for h in tres.history]
    assert len(tl) == 2 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tres.comm.trainable_bytes == jres.comm.trainable_bytes
    assert tres.comm.full_bytes == jres.comm.full_bytes
    y0 = dict(jbasic.flatten_params(jpart.partition(
        jdlm.init_model(jcfg, 0), jcfg.freeze_spec)[0]))
    jy = dict(jbasic.flatten_params(jres.y))
    ty = dict(tbasic.flatten_params(tres.y))
    assert sorted(ty) == sorted(jy) == sorted(y0)
    diff = step = 0.0
    for path, w in jy.items():
        w, a = np.asarray(w, np.float64), np.asarray(y0[path], np.float64)
        diff += float(((ty[path].double().numpy() - w) ** 2).sum())
        step += float(((w - a) ** 2).sum())
    print(f"run_reduced_arch: ||dy_port - dy_jax|| / ||dy_jax|| = "
          f"{(diff / step) ** 0.5:.3e}")
    assert diff ** 0.5 <= UPDATE_REL * step ** 0.5


def test_train_cli_prints_the_reference_line(mixtral_runs, capsys):
    jres = mixtral_runs[0]
    ttrain.main(["--arch", "mixtral-8x7b", "--reduced", "--rounds", "2",
                 "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    share = 100 * jres.comm.trainable_bytes / jres.comm.full_bytes
    assert f"arch=mixtral-8x7b trainable share: {share:.2f}%" in out
    assert re.fullmatch(r"final loss=\d+\.\d{4} comm reduction=\d+\.\dx "
                        r"sec/round=(\d+\.\d\d|nan)", out[-1]), out[-1]
