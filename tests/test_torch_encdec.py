"""The port's encoder-decoder stack (Whisper large-v3) against the JAX
package, on its ``reduced_config`` (2 encoder and 2 decoder layers,
d_model 256, 4 heads of 64, LayerNorm, ungated GELU, sinusoid positions,
vocab 512, 16 encoder frames, float32 compute), with the same numpy
inputs: the config, the init's leaves (the decoder stack from its
``/dec`` root with ``ln_cross`` / ``cross_attn``, ``enc_layers``,
``enc_norm``), ``forward`` logits with random non-zero
``encoder_embeds`` and without, ``train_loss`` and its gradient into the
trainable tree, ``init_cache`` with its ``cross`` entry,
``build_cross_cache``, greedy decode against a built cross cache and
against ``init_cache``'s zero one (the reference's ``generate``), decode
against ``forward``, a 2-round ``run_reduced_arch`` history, and
``flash_attention`` non-causal with other rows in q than in k
(cross-attention).

Tolerances, the zoo's (``tests/test_torch_zoo.py``): init within 4 ulps,
zeros exact; outputs from the reference's own weights in float32, dot
products of 256 to 1024 terms summed in other orders: logits, caches and
losses rtol / atol 1e-4, each gradient leaf within 1e-4 of its largest
|entry|; the history's losses within rel 1e-4, the trained y by update
norm within 1e-3 of JAX's update. Decode against ``forward`` within the
same 1e-4: the one-token step attends with a plain softmax where
``forward`` runs the chunked online softmax, both in float32.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.configs import load_all
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

load_all()
ARCH = "whisper-large-v3"
RTOL = ATOL = 1e-4
GRAD_REL = 1e-4
ULPS = 4
UPDATE_REL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """These cases run small shapes through many small torch ops: with
    one intra-op thread they keep their arithmetic and run several times
    faster under the parallel test runner, whose workers' default thread
    pools would otherwise spin on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    jcfg = jreduced(jget(ARCH)).with_(**kw)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


@pytest.fixture(scope="module")
def params():
    """(JAX params, the port's copy of them) of the reduced config."""
    jp = jdlm.init_model(_cfgs()[0], 0)
    return jp, _to_torch(jp)


def _tokens(seed, vocab, *shape):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _frames(seed, B, cfg):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def test_config_is_the_references():
    full = tbase.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jget(ARCH))
    assert dataclasses.asdict(ttrain.reduced_config(full)) \
        == dataclasses.asdict(_cfgs()[0])
    assert full.is_encoder_decoder and (full.encoder_layers,
                                        full.encoder_seq_len) == (32, 1500)
    assert tbase.match_freeze("enc_layers/slot0/ffn/wi/kernel",
                              full.freeze_spec)
    assert not tbase.match_freeze("layers/slot0/ffn/wi/kernel",
                                  full.freeze_spec)


def test_init_leaves_match_jax(params):
    jp, _ = params
    got = dict(tbasic.flatten_params(tdlm.init_model(_cfgs()[1], 0,
                                                     device="cpu")))
    want = dict(jbasic.flatten_params(jp))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, path
        assert _ulps(g.numpy(), w) <= ULPS, path
        if "/ln" in path or "norm" in path or path.endswith("/bias"):
            assert not g.any(), path
    for path in ("layers/slot0/ln_cross/scale",
                 "layers/slot0/cross_attn/wq/kernel",
                 "enc_layers/slot0/attn/wq/kernel", "enc_norm/scale"):
        assert path in got, path
    assert "cross_attn" not in str(sorted(p for p in got
                                          if p.startswith("enc_")))
    # the decoder's self-attention comes from the "/dec" root, the
    # encoder's from the plain one
    assert not torch.equal(got["layers/slot0/attn/wq/kernel"],
                           got["enc_layers/slot0/attn/wq/kernel"])


@pytest.mark.parametrize("with_frames", [True, False])
def test_forward_logits_match_jax(params, with_frames):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    toks = _tokens(1, jcfg.vocab_size, 2, 12)
    jkw, tkw = {}, {}
    if with_frames:
        fr = _frames(2, 2, jcfg)
        jkw["encoder_embeds"] = jnp.asarray(fr)
        tkw["encoder_embeds"] = torch.from_numpy(fr)
    jl, _ = jdlm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    tl, _ = tdlm.forward(tp, tcfg, torch.from_numpy(toks), **tkw)
    assert tl.shape == (2, 12, jcfg.vocab_size)
    _close(tl, jl)


def test_train_loss_and_gradient_match_jax(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    toks = _tokens(3, jcfg.vocab_size, 2, 16)
    fr = _frames(4, 2, jcfg)
    mask = (np.arange(16)[None, :] < np.array([[16], [9]])).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask), "encoder_embeds": jnp.asarray(fr)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "mask": torch.from_numpy(mask),
          "encoder_embeds": torch.from_numpy(fr)}
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
    assert "enc_layers/slot0/attn/wq/kernel" in got
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_init_cache_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    jc = jdlm.init_cache(jcfg, 2, 24)
    tc = tdlm.init_cache(tcfg, 2, 24, device="cpu")
    for part in ("slots", "cross"):
        want = dict(jbasic.flatten_params(jc[part]))
        got = dict(tbasic.flatten_params(tc[part]))
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            assert tuple(got[path].shape) == w.shape, path
            assert str(got[path].dtype)[6:] == str(w.dtype), path
            assert not got[path].any()
    assert tc["cross"]["slot0"]["k"].shape == (2, 2, 16, 4, 64)


def test_build_cross_cache_matches_jax(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    fr = _frames(5, 2, jcfg)
    want = dict(jbasic.flatten_params(
        jdlm.build_cross_cache(jp, jcfg, jnp.asarray(fr))))
    got = dict(tbasic.flatten_params(
        tdlm.build_cross_cache(tp, tcfg, torch.from_numpy(fr))))
    assert sorted(got) == sorted(want) == ["slot0/k", "slot0/v"]
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape == (2, 2, 16, 4, 64)
        _close(got[path], w)


def _greedy(step, cache, prompt, steps):
    """Greedy tokens (B, P + steps) and every step's logits from stepping
    ``prompt`` through ``step(cache, tokens (B, 1))``."""
    out, logits = [prompt], []
    for t in range(prompt.shape[1] + steps):
        tok = (prompt[:, t:t + 1] if t < prompt.shape[1]
               else np.asarray(logits[-1][:, -1]).argmax(-1)[:, None]
               .astype(np.int32))
        if t >= prompt.shape[1]:
            out.append(tok)
        lg, cache = step(cache, tok)
        logits.append(np.asarray(lg))
    return np.concatenate(out, 1), np.concatenate(logits, 1)


def test_greedy_decode_with_a_built_cross_cache_matches_jax(params):
    """Whisper's serving loop: the encoder's K / V cached once
    (``build_cross_cache``), then 4 prompt tokens stepped and 8 greedy
    steps against it, both packages; and the reference's ``generate``
    (the zero cross cache of ``init_cache``)."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    fr = _frames(6, 2, jcfg)
    prompt = _tokens(7, jcfg.vocab_size, 2, 4)
    jc = jdlm.init_cache(jcfg, 2, 12)
    jc["cross"] = jdlm.build_cross_cache(jp, jcfg, jnp.asarray(fr))
    jstep = jax.jit(lambda c, t: jdlm.decode_step(jp, jcfg, c, t))
    jseq, jlog = _greedy(lambda c, t: jstep(c, jnp.asarray(t)), jc, prompt, 8)
    tc = tdlm.init_cache(tcfg, 2, 12, device="cpu")
    tc["cross"] = tdlm.build_cross_cache(tp, tcfg, torch.from_numpy(fr))
    tseq, tlog = _greedy(
        lambda c, t: tdlm.decode_step(tp, tcfg, c, torch.from_numpy(t)),
        tc, prompt, 8)
    np.testing.assert_array_equal(tseq, jseq)
    _close(torch.from_numpy(tlog), jlog)
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tserve.generate(tp, tcfg, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_forward(params):
    """The stepped decode against the cross cache equals ``forward`` with
    the same frames at every position."""
    jcfg, tcfg = _cfgs()
    _, tp = params
    fr = torch.from_numpy(_frames(8, 2, jcfg))
    toks = _tokens(9, jcfg.vocab_size, 2, 10)
    cache = tdlm.init_cache(tcfg, 2, 10, device="cpu")
    cache["cross"] = tdlm.build_cross_cache(tp, tcfg, fr)
    steps = []
    for t in range(10):
        lg, cache = tdlm.decode_step(tp, tcfg, cache,
                                     torch.from_numpy(toks[:, t:t + 1]))
        steps.append(lg)
    full, _ = tdlm.forward(tp, tcfg, torch.from_numpy(toks),
                           encoder_embeds=fr)
    _close(torch.cat(steps, 1), full.detach().numpy())


def test_prefill_step_passes_the_frames(params):
    jcfg, tcfg = _cfgs()
    _, tp = params
    fr = _frames(10, 2, jcfg)
    toks = _tokens(11, jcfg.vocab_size, 2, 8)
    y, z = tspecs.serving_split(tbasic.tree_map(lambda x: x, tp), tcfg)
    got = tspecs.make_prefill_step(tcfg, device="cpu")(
        y, z, {"tokens": toks, "encoder_embeds": fr})
    want, _ = tdlm.forward(tpart.merge(y, z), tcfg, torch.from_numpy(toks),
                           encoder_embeds=torch.from_numpy(fr))
    assert torch.equal(got, want)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 12)" in out and "on cpu" in out


@pytest.mark.parametrize("sq,skv", [(12, 40), (40, 12), (7, 1500)])
def test_cross_attention_matches_jax(sq, skv):
    """Non-causal attention with other rows in q than in k and v (decoder
    queries against encoder frames), chunks of 16 and 512 (a ragged last
    chunk), the config's window ignored as the reference ignores it."""
    jcfg, tcfg = _cfgs(sliding_window=5)
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 4, 64)).astype(np.float32)
            for _ in range(2))
    for chunk in (16, 512):
        want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jcfg, chunk=chunk,
                                     causal=False)
        got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), tcfg, chunk=chunk,
                                    causal=False)
        assert got.shape == (2, sq, 4, 64)
        _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def runs():
    jres, jcfg = jrun_reduced_arch(ARCH, 2, log=False)
    tres, tcfg = ttrain.run_reduced_arch(ARCH, 2, log=False, device="cpu")
    return jres, jcfg, tres, tcfg


def test_run_reduced_arch_matches_the_reference(runs):
    """2 rounds of FedPT (the encoder FFNs frozen) with the reference's
    zero frames."""
    jres, jcfg, tres, tcfg = runs
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
