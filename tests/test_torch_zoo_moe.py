"""The port's Mixtral-8x7B (the MoE family) against the JAX package, on
its ``reduced_config`` (2 layers, d_model 256, 4 heads, vocab 512, 4
experts top-2, float32 compute): the stacked init, ``forward`` logits
and the MoE aux loss, ``train_loss`` and its gradient into the trainable
tree, one federated step, ``train_loss``'s chunked attention, decode
against JAX's decode (capacity 1.25, drops included), decode against
``forward`` at capacity 8.0, 24 steps through an 8-slot ring,
``run_reduced_arch`` for 2 rounds and the training CLI. The first
four cases and the tolerances are ``tests/_torch_zoo_cases.py``'s.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.partition as jpart
from repro.launch.train import run_reduced_arch as jrun_reduced_arch
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro_torch.configs import base as tbase
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

from _torch_zoo_cases import (  # noqa: F401
    RTOL, UPDATE_REL, _cfgs, _close, _one_intra_op_thread, _params, _tokens,
    pytest_generate_tests, test_forward_logits_and_aux_match_jax,
    test_init_leaves_match_jax, test_one_federated_train_step,
    test_train_loss_and_gradient_match_jax)

FAMILY = ["mixtral-8x7b"]


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
