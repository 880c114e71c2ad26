"""The port's decoder LM serving path against the JAX package, on reduced
Mistral-NeMo (2 layers, d_model 256, 4 heads of 64, vocab 512, float32
compute) with GQA (``num_kv_heads=2``, which ``reduced_config`` alone
does not give): configs, the stacked init, ``forward`` logits and caches,
48 decode steps through a 16-slot ring, greedy ``generate``, the prefill
and decode steps on the (trainable, frozen) split, and the weight bridge.

Tolerances. Init: zeros exact, normals within 4 ulps (the threefry bits
are JAX's; torch's and XLA's erfinv round differently, as
``tests/test_torch_prng.py`` establishes). Model outputs are computed
from the reference's own weights (carried across by the bridge) in
float32; the two packages sum 256- to 1024-long dot products in other
orders, a few ulps of the largest term per layer, so logits and caches of
O(1) agree to rtol 1e-4 / atol 1e-4. Greedy tokens are equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch import specs as jspecs
from repro.launch.train import reduced_config as jreduced
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.launch import specs as tspecs
from repro_torch.launch import train as ttrain
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

RTOL = ATOL = 1e-4
ULPS = 4
ARCH = "mistral-nemo-12b"


def _cfgs(window=0):
    jcfg = jreduced(jget(ARCH)).with_(num_kv_heads=2, sliding_window=window)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def jax_params():
    return jdlm.init_model(_cfgs()[0], 0)


@pytest.fixture(scope="module")
def params(jax_params):
    return bridge.from_numpy_tree(jax_params, device="cpu")


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


def test_configs_match_the_reference():
    full = jget(ARCH)
    assert dataclasses.asdict(tbase.get_config(ARCH)) == dataclasses.asdict(full)
    assert dataclasses.asdict(ttrain.reduced_config(tbase.get_config(ARCH))) \
        == dataclasses.asdict(jreduced(full))
    cfg = tbase.get_config(ARCH)
    assert cfg.pdtype == torch.float32 and cfg.cdtype == torch.bfloat16
    assert tbase.match_freeze("layers/slot0/ffn/wo/kernel", cfg.freeze_spec)
    assert not tbase.match_freeze("layers/slot0/attn/wo/kernel", cfg.freeze_spec)
    assert tspecs.serving_config(cfg, "long_500k").sliding_window == 8192
    assert tspecs.serving_config(cfg, "prefill_32k").sliding_window == 0
    assert tspecs.SHAPES == jspecs.SHAPES
    assert tbase.get_config("paligemma-3b").family == "vlm"
    assert tbase.get_config("whisper-large-v3").is_encoder_decoder
    with pytest.raises(KeyError, match="unknown"):
        tbase.get_config("no-such-arch")


def test_init_leaves_match_jax(jax_params):
    tcfg = _cfgs()[1]
    got = dict(tbasic.flatten_params(tdlm.init_model(tcfg, 0, device="cpu")))
    want = dict(jbasic.flatten_params(jax_params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        assert _ulps(g.numpy(), w) <= ULPS, path
        if "/ln" in path or "norm" in path:
            assert not g.any(), path
    assert got["layers/slot0/attn/wq/kernel"].shape == (2, 256, 256)


def test_bridge_carries_the_stacked_tree(jax_params, params):
    want = dict(jbasic.flatten_params(jax_params))
    got = dict(tbasic.flatten_params(params))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape and got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(w))
    back = dict(tbasic.flatten_params(bridge.to_numpy_tree(params)))
    for path, w in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(w))


@pytest.mark.parametrize("window", [0, 16])
def test_forward_logits_and_caches_match_jax(jax_params, params, window):
    jcfg, tcfg = _cfgs(window)
    toks = _tokens(window, 2, 40)
    jl, jm, jc = jdlm.forward(jax_params, jcfg, jnp.asarray(toks),
                              return_caches=True)
    tl, tm, tc = tdlm.forward(params, tcfg, torch.from_numpy(toks),
                              return_caches=True)
    _close(tl, jl)
    assert float(tm["moe_aux_loss"]) == float(jm["moe_aux_loss"]) == 0.0
    assert len(tc) == len(jc) == 1
    for g, w in zip(tc[0], jc[0]):
        assert tuple(g.shape) == w.shape == (2, 2, 40, 2, 64)
        _close(g, w)
    labels = _tokens(7, 2, 40)
    _close(tdlm.lm_loss(tl, torch.from_numpy(labels)),
           jdlm.lm_loss(jl, jnp.asarray(labels)))


def test_decode_steps_through_a_wrapped_ring(jax_params, params):
    """48 steps at window 16 with max_len 64: a 16-slot ring that wraps
    twice; every step's logits and the final caches against JAX's."""
    jcfg, tcfg = _cfgs(16)
    assert tdlm.cache_capacity(tcfg, 64) == jdlm.cache_capacity(jcfg, 64) == 16
    toks = _tokens(11, 2, 48)
    jcache = jdlm.init_cache(jcfg, 2, 64)
    tcache = tdlm.init_cache(tcfg, 2, 64, device="cpu")
    for t in range(48):
        jl, jcache = jdlm.decode_step(jax_params, jcfg, jcache,
                                      jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tdlm.decode_step(params, tcfg, tcache,
                                      torch.from_numpy(toks[:, t:t + 1]))
        _close(tl, jl)
    assert tcache["cache_len"] == int(jcache["cache_len"]) == 48
    for name in ("k", "v"):
        _close(tcache["slots"]["slot0"][name], jcache["slots"]["slot0"][name])


@pytest.mark.parametrize("window,steps,max_len", [(0, 16, 0), (16, 40, 64)])
def test_generate_greedy_tokens_equal_jax(jax_params, params, window, steps,
                                          max_len):
    jcfg, tcfg = _cfgs(window)
    prompt = _tokens(3, 2, 8)
    want = np.asarray(jserve.generate(jax_params, jcfg, jnp.asarray(prompt),
                                      steps, max_len=max_len))
    got = tserve.generate(params, tcfg, prompt, steps, max_len=max_len,
                          device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_by_step_prefill_agrees_with_forward(params):
    """``generate``'s prefill (decode_attention over the cache) against
    ``forward``'s logits at every prompt position (flash attention)."""
    tcfg = _cfgs(16)[1]
    prompt = torch.from_numpy(_tokens(5, 2, 24))
    stepped, cache = tserve.prefill_by_steps(params, tcfg, prompt, 32,
                                             device="cpu")
    full, _ = tdlm.forward(params, tcfg, prompt)
    assert cache["cache_len"] == 24
    _close(stepped, full.numpy())


def test_prefill_and_decode_steps_on_the_split(jax_params, params):
    """The serving split (trainable f32, frozen bf16) through both
    packages' step functions: the same frozen bf16 values, merged back."""
    jcfg, tcfg = _cfgs(16)
    # serving_split consumes its tree's frozen leaves: give it a copy
    y, z = tspecs.serving_split(tbasic.tree_map(lambda x: x, params), tcfg)
    assert {p for p, _ in tbasic.flatten_params(z)} == {
        f"layers/slot0/ffn/{n}/kernel" for n in ("wi_gate", "wi_up", "wo")}
    assert all(x.dtype == torch.bfloat16 for x in tbasic.tree_leaves(z))
    assert all(x.dtype == torch.float32 for x in tbasic.tree_leaves(y))
    jy, jz = jpart.partition(jax_params, jcfg.freeze_spec)
    jz = jbasic.unflatten_params({p: jnp.asarray(x, jnp.bfloat16)
                                  for p, x in jbasic.flatten_params(jz)})
    toks = _tokens(9, 2, 20)
    want = jspecs.make_prefill_step(jcfg)(jy, jz, {"tokens": jnp.asarray(toks)})
    got = tspecs.make_prefill_step(tcfg, device="cpu")(y, z, {"tokens": toks})
    _close(got, want)
    jstep, tstep = jspecs.make_decode_step(jcfg), tspecs.make_decode_step(
        tcfg, device="cpu")
    jcache = jdlm.init_cache(jcfg, 2, 32)
    tcache = tdlm.init_cache(tcfg, 2, 32, device="cpu")
    for t in range(4):
        jl, jcache = jstep(jy, jz, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = tstep(y, z, tcache, toks[:, t:t + 1])
        _close(tl, jl)
    # the shapes-only split: the full-width NeMo's 1,552 M trainable f32
    # and 881 M frozen bf16 parameters, with no memory behind them
    ys, zs = tspecs.param_structs(tbase.get_config(ARCH).with_(num_layers=4))
    assert tbasic.tree_size(ys) == 1_551_938_560
    assert tbasic.tree_size(zs) == 880_803_840
    assert all(x.device.type == "meta" for x in tbasic.tree_leaves(zs))


def test_steps_refuse_parameters_on_another_device(params):
    tcfg = _cfgs()[1]
    y, z = tspecs.serving_split(tbasic.tree_map(lambda x: x, params), tcfg)
    meta = tbasic.tree_map(lambda x: x.to("meta"), y)
    with pytest.raises(ValueError, match="meta"):
        tspecs.make_prefill_step(tcfg, device="cpu")(meta, z,
                                                     {"tokens": _tokens(0, 1, 4)})


def test_unported_features_raise(params):
    """The stacks that waited for their slices now build and run: the
    VLM prefix and the encoder-decoder stack on NeMo's reduced widths
    (``tests/test_torch_vlm.py`` and ``test_torch_encdec.py`` hold them
    against the JAX package); MLA (tests/test_torch_mla.py) and the SSM
    slots (tests/test_torch_ssm.py) were ported before."""
    tcfg = _cfgs()[1]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    vlm = tcfg.with_(family="vlm", num_prefix_tokens=3)
    p = tdlm.init_model(vlm, 0, device="cpu")
    assert tuple(p["mm_proj"]["kernel"].shape) == (1152, vlm.d_model)
    pe = torch.ones((1, 3, 1152))
    logits, _ = tdlm.forward(p, vlm, toks, prefix_embeds=pe)
    assert logits.shape == (1, 7, vlm.vocab_size)
    assert bool(torch.isfinite(logits).all())
    encdec = tcfg.with_(is_encoder_decoder=True, encoder_layers=1,
                        encoder_seq_len=5)
    p = tdlm.init_model(encdec, 0, device="cpu")
    assert "cross_attn" in p["layers"]["slot0"] and "enc_norm" in p
    logits, _ = tdlm.forward(p, encdec, toks,
                             encoder_embeds=torch.ones((1, 5, tcfg.d_model)))
    assert logits.shape == (1, 4, encdec.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 12)" in out and "on cpu" in out


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False)])
def test_norms_activations_and_mlp_match_jax(act, gated):
    """float32: rmsnorm / layernorm scale by 1 + scale; gelu is the tanh
    approximation (``jax.nn.gelu``'s default); 256- and 1024-long dot
    products in the MLP, so rtol / atol 1e-5."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 256)).astype(np.float32)
    scale, bias = (rng.standard_normal(256).astype(np.float32) * 0.1
                   for _ in range(2))
    tx = torch.from_numpy(x)
    _close(tbasic.rmsnorm(tx, torch.from_numpy(scale)),
           jbasic.rmsnorm(jnp.asarray(x), jnp.asarray(scale)), 1e-5, 1e-5)
    _close(tbasic.layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias)),
           jbasic.layernorm(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias)), 1e-5, 1e-5)
    _close(tbasic.activation(act)(tx), jbasic.activation(act)(jnp.asarray(x)),
           1e-6, 1e-6)
    jp = jbasic.init_mlp(0, "mlp", 256, 1024, jnp.float32, gated=gated)
    want = jbasic.mlp(jnp.asarray(x), jp, act, jnp.float32)
    got = tbasic.mlp(tx, bridge.from_numpy_tree(jp, device="cpu"), act,
                     torch.float32)
    _close(got, want, 1e-5, 1e-5)
    tp = tbasic.init_mlp(0, "mlp", 256, 1024, torch.float32, gated=gated,
                         device="cpu")
    assert sorted(tp) == sorted(jp)


def test_sinusoid_positions_and_a_rope_free_model_match_jax():
    pos = np.arange(40)[None, :]
    _close(tdlm.sinusoid_pos(torch.from_numpy(pos), 256, torch.float32),
           jdlm.sinusoid_pos(jnp.asarray(pos), 256, jnp.float32), 1e-5, 2e-5)
    jcfg, tcfg = (c.with_(use_rope=False, norm_type="layernorm", act="gelu",
                          tie_embeddings=True) for c in _cfgs())
    jp = jdlm.init_model(jcfg, 1)
    toks = _tokens(2, 2, 24)
    want, _ = jdlm.forward(jp, jcfg, jnp.asarray(toks))
    got, _ = tdlm.forward(bridge.from_numpy_tree(jp, device="cpu"), tcfg,
                          torch.from_numpy(toks))
    _close(got, want)
    assert "unembed" not in tdlm.init_model(tcfg, 1, device="cpu")
