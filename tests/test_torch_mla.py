"""The port's MLA (DeepSeek-V2's multi-head latent attention) and the
reduced DeepSeek-V2 against the JAX package, on the same numpy inputs and
the reference's own weights (carried across by the bridge):
``init_mla``'s leaves with and without the q LoRA bottleneck,
``mla_qkv``, ``mla_compress`` and the absorbed-form ``mla_decode``, the
chunked attention with a v head dim unlike q's against the reference's
``flash_attention`` at chunks 64 and 512, and on ``launch/train.
reduced_config`` of DeepSeek-V2 (2 layers, d_model 256, 4 heads, q / k
heads of 48 = 32 + 16 rope, v heads of 32, kv_lora 64, q_lora 96, 4
experts top-2 and the config's 2 shared experts, vocab 512, float32
compute): ``forward`` logits and the (c_kv, k_pe) caches, 6 decode steps
and their caches, decode against ``forward``, greedy ``generate``,
``train_loss`` and its gradient into the trainable tree, and a 2-round
``run_reduced_arch`` history.

Tolerances. Init: zeros exact, normals within 4 ulps (the threefry bits
are JAX's; torch's and XLA's erfinv round differently, as
``tests/test_torch_prng.py`` establishes). The MLA functions sum 64- to
256-long float32 dot products in another order than XLA, a few ulps of
O(1) outputs: rtol / atol 1e-5. Model outputs go through two layers, the
router and the experts: rtol / atol 1e-4, each gradient leaf within 1e-4
of its largest |entry| (``tests/test_torch_zoo.py``'s bounds). Decode
against ``forward`` at capacity factor 8.0 (no token drops): 2e-4, the
absorbed and the expanded forms summing the same products in other
orders. Training: the two runs' losses within rel 1e-4 and the trained y
by update norm, ||dy_port - dy_jax|| <= 1e-3 ||dy_jax||. Greedy tokens
are equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch.train import reduced_config as jreduced
from repro.launch.train import run_reduced_arch as jrun_reduced_arch
from repro.models import decoder_lm as jdlm
from repro.nn import attention as jattn
from repro.nn import basic as jbasic
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import partition as tpart
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import attention as tattn
from repro_torch.nn import basic as tbasic

ARCH = "deepseek-v2-236b"
MLA_TOL = 1e-5
RTOL = ATOL = 1e-4
GRAD_REL = 1e-4
ULPS = 4
UPDATE_REL = 1e-3
PATH = "layers/slot0/attn"


def _cfgs(**kw):
    jcfg = jreduced(jget(ARCH)).with_(**kw)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jdlm.init_model(_cfgs()[0], 0)


@pytest.fixture(scope="module")
def params(jax_params):
    return _to_torch(jax_params)


def _tokens(seed, *shape):
    return np.random.default_rng(seed).integers(0, 512, shape, dtype=np.int32)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _mla(q_lora_rank):
    """(JAX config, port config, JAX MLA leaves, the port's copy) of one
    MLA layer of the reduced config."""
    jcfg, tcfg = _cfgs(q_lora_rank=q_lora_rank)
    jp = jattn.init_mla(5, PATH, jcfg, jnp.float32)
    return jcfg, tcfg, jp, _to_torch(jp)


def test_config_is_the_references():
    full = tbase.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jget(ARCH))
    assert full.use_mla
    assert (full.kv_lora_rank, full.q_lora_rank) == (512, 1536)
    assert (full.qk_nope_head_dim + full.qk_rope_head_dim,
            full.v_head_dim) == (192, 128)
    assert dataclasses.asdict(ttrain.reduced_config(full)) \
        == dataclasses.asdict(_cfgs()[0])
    assert tbase.match_freeze("layers/slot0/moe/wi_gate", full.freeze_spec)
    assert not tbase.match_freeze("layers/slot0/moe/shared/wo/kernel",
                                  full.freeze_spec)


@pytest.mark.parametrize("q_lora_rank", [96, 0])
def test_init_mla_leaves_match_jax(q_lora_rank):
    jcfg, tcfg, jp, _ = _mla(q_lora_rank)
    got = dict(tbasic.flatten_params(
        tattn.init_mla(5, PATH, tcfg, torch.float32, device="cpu")))
    want = dict(jbasic.flatten_params(jp))
    assert sorted(got) == sorted(want)
    assert ("wq_a/kernel" in got) == (q_lora_rank > 0) != ("wq/kernel" in got)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        assert _ulps(g.numpy(), w) <= ULPS, path
        if "norm" in path:
            assert not g.any(), path


@pytest.mark.parametrize("q_lora_rank", [96, 0])
def test_mla_qkv_and_compress_match_jax(q_lora_rank):
    jcfg, tcfg, jp, tp = _mla(q_lora_rank)
    x = _rand(1, 2, 12, 256)
    pos = np.arange(12)[None, :]
    jq, jk, jv, (jckv, jkpe) = jattn.mla_qkv(jnp.asarray(x), jp, jcfg,
                                             jnp.asarray(pos))
    tq, tk, tv, (tckv, tkpe) = tattn.mla_qkv(torch.from_numpy(x), tp, tcfg,
                                             torch.from_numpy(pos))
    assert tuple(tq.shape) == tuple(tk.shape) == (2, 12, 4, 48)
    assert tuple(tv.shape) == (2, 12, 4, 32)
    for g, w in ((tq, jq), (tk, jk), (tv, jv), (tckv, jckv), (tkpe, jkpe)):
        assert tuple(g.shape) == w.shape
        _close(g, w, MLA_TOL, MLA_TOL)
    # the rope part of k is one shared head
    assert torch.equal(tk[..., 32:], tk[:, :, :1, 32:].expand(-1, -1, 4, -1))
    cpos = np.array([[7, 8, 9]])
    jc = jattn.mla_compress(jnp.asarray(x[:, :3]), jp, jcfg, jnp.asarray(cpos))
    tc = tattn.mla_compress(torch.from_numpy(x[:, :3]), tp, tcfg,
                            torch.from_numpy(cpos))
    for g, w in zip(tc, jc):
        _close(g, w, MLA_TOL, MLA_TOL)


@pytest.mark.parametrize("cache_len", [13, "per_row"])
@pytest.mark.parametrize("q_lora_rank", [96, 0])
def test_mla_decode_matches_jax(q_lora_rank, cache_len):
    """The absorbed form against a 16-slot compressed cache, the valid
    length one int or one a row."""
    jcfg, tcfg, jp, tp = _mla(q_lora_rank)
    x, ckv, kpe = _rand(2, 3, 1, 256), _rand(3, 3, 16, 64), _rand(4, 3, 16, 16)
    cl = np.array([13, 1, 16], np.int32) if cache_len == "per_row" else 13
    want = jattn.mla_decode(jnp.asarray(x), jp, jcfg, jnp.asarray(ckv),
                            jnp.asarray(kpe), jnp.asarray(cl))
    got = tattn.mla_decode(torch.from_numpy(x), tp, tcfg,
                           torch.from_numpy(ckv), torch.from_numpy(kpe),
                           torch.from_numpy(np.asarray(cl)) if
                           cache_len == "per_row" else cl)
    assert tuple(got.shape) == (3, 1, 256)
    _close(got, want, MLA_TOL, MLA_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunk", [64, 512])
def test_chunked_attention_with_a_v_head_dim_unlike_qs(chunk, causal):
    """q / k heads of 48, v heads of 32, S = 200 (ragged at both chunks):
    the port's chunked attention, and its CPU ``flash_attention``, against
    the reference's ``flash_attention`` at the same chunk."""
    jcfg, tcfg = _cfgs()
    q, k, v = _rand(5, 2, 200, 4, 48), _rand(6, 2, 200, 4, 48), \
        _rand(7, 2, 200, 4, 32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jcfg, chunk=chunk,
                                 causal=causal)
    args = [torch.from_numpy(t) for t in (q, k, v)]
    got = tattn.chunked_attention(*args, tcfg, chunk=chunk, causal=causal)
    assert tuple(got.shape) == (2, 200, 4, 32)
    _close(got, want, MLA_TOL, MLA_TOL)
    _close(tattn.flash_attention(*args, tcfg, chunk=chunk, causal=causal),
           want, MLA_TOL, MLA_TOL)


def test_init_model_leaves_match_jax(jax_params):
    got = dict(tbasic.flatten_params(
        tdlm.init_model(_cfgs()[1], 0, device="cpu")))
    want = dict(jbasic.flatten_params(jax_params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        assert tuple(got[path].shape) == w.shape, path
        assert _ulps(got[path].numpy(), w) <= ULPS, path
    assert got[f"{PATH}/wq_b/kernel"].shape == (2, 96, 4 * 48)
    assert got["layers/slot0/moe/shared/wi_gate/kernel"].shape == (2, 256,
                                                                   1024)


def test_forward_logits_and_caches_match_jax(jax_params, params):
    jcfg, tcfg = _cfgs()
    toks = _tokens(1, 2, 24)
    jl, jm, jc = jdlm.forward(jax_params, jcfg, jnp.asarray(toks),
                              return_caches=True)
    tl, tm, tc = tdlm.forward(params, tcfg, torch.from_numpy(toks),
                              return_caches=True)
    _close(tl, jl)
    np.testing.assert_allclose(float(tm["moe_aux_loss"]),
                               float(jm["moe_aux_loss"]), rtol=1e-5)
    assert len(tc) == len(jc) == 1
    shapes = [(2, 2, 24, 64), (2, 2, 24, 16)]
    for g, w, shape in zip(tc[0], jc[0], shapes):
        assert tuple(g.shape) == w.shape == shape
        _close(g, w)


def test_decode_steps_and_caches_match_jax(jax_params, params):
    """6 decode steps from the (c_kv, k_pe) cache: each step's logits and
    the final caches against JAX's decode."""
    jcfg, tcfg = _cfgs()
    toks = _tokens(2, 2, 6)
    jcache = jdlm.init_cache(jcfg, 2, 8)
    tcache = tdlm.init_cache(tcfg, 2, 8, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache["slots"]["slot0"].items()} \
        == {"ckv": (2, 2, 8, 64), "kpe": (2, 2, 8, 16)}
    for t in range(6):
        jl, jcache = jdlm.decode_step(jax_params, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tdlm.decode_step(params, tcfg, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl)
    assert tcache["cache_len"] == int(jcache["cache_len"]) == 6
    for name in ("ckv", "kpe"):
        _close(tcache["slots"]["slot0"][name], jcache["slots"]["slot0"][name])


def test_decode_agrees_with_forward(params):
    """The absorbed-form decode against the expanded ``forward`` at every
    prompt position, at capacity factor 8.0 (no token drops)."""
    tcfg = _cfgs(moe_capacity_factor=8.0)[1]
    prompt = torch.from_numpy(_tokens(3, 2, 12))
    stepped, cache = tserve.prefill_by_steps(params, tcfg, prompt, 16,
                                             device="cpu")
    full, _ = tdlm.forward(params, tcfg, prompt)
    assert cache["cache_len"] == 12
    _close(stepped, full.numpy(), 2e-4, 2e-4)


def test_generate_greedy_tokens_equal_jax(jax_params, params):
    jcfg, tcfg = _cfgs()
    prompt = _tokens(4, 2, 8)
    want = np.asarray(jserve.generate(jax_params, jcfg, jnp.asarray(prompt),
                                      8))
    got = tserve.generate(params, tcfg, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_split_and_steps(params):
    """The serving split freezes the routed experts to bf16; prefill and
    decode steps on it run, and the full-width shapes-only split counts
    DeepSeek-V2's parameters at 2 layers."""
    tcfg = _cfgs()[1]
    # serving_split consumes its tree's frozen leaves: give it a copy
    y, z = tspecs.serving_split(tbasic.tree_map(lambda x: x, params), tcfg)
    assert {p for p, _ in tbasic.flatten_params(z)} == {
        f"layers/slot0/moe/{n}" for n in ("wi_gate", "wi_up", "wo")}
    toks = _tokens(5, 1, 10)
    logits = tspecs.make_prefill_step(tcfg, device="cpu")(y, z,
                                                          {"tokens": toks})
    assert tuple(logits.shape) == (1, 10, 512)
    cache = tdlm.init_cache(tcfg, 1, 4, device="cpu")
    step = tspecs.make_decode_step(tcfg, device="cpu")
    out, cache = step(y, z, cache, toks[:, :1])
    assert tuple(out.shape) == (1, 1, 512) and cache["cache_len"] == 1
    ys, zs = tspecs.param_structs(tbase.get_config(ARCH).with_(num_layers=2))
    assert (tbasic.tree_size(ys), tbasic.tree_size(zs)) == (1_443_066_880,
                                                            7_549_747_200)


def test_train_loss_and_gradient_match_jax(jax_params, params):
    jcfg, tcfg = _cfgs()
    toks = _tokens(6, 2, 24)
    mask = (np.arange(24)[None, :] < np.array([[24], [17]])).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "mask": torch.from_numpy(mask)}
    jy, jz = jpart.partition(jax_params, jcfg.freeze_spec)
    ty, tz = tpart.partition(params, tcfg.freeze_spec)
    jv, jg = jax.value_and_grad(
        lambda y: jdlm.train_loss(jpart.merge(y, jz), jcfg, jb)[0])(jy)
    tg, tv = torch.func.grad_and_value(
        lambda y: tdlm.train_loss(tpart.merge(y, tz), tcfg, tb)[0])(ty)
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    want = dict(jbasic.flatten_params(jg))
    got = dict(tbasic.flatten_params(tg))
    assert sorted(got) == sorted(want)
    assert f"{PATH}/wk_b/kernel" in got
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_run_reduced_arch_matches_the_reference():
    jres, jcfg = jrun_reduced_arch(ARCH, 2, log=False)
    tres, tcfg = ttrain.run_reduced_arch(ARCH, 2, log=False, device="cpu")
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
