"""The port's VLM stack (PaliGemma-3B) against the JAX package, on its
``reduced_config`` (2 layers, d_model 256, 4 heads of 64 over one kv
head, GeGLU, tied vocab 512, 8 prefix tokens, float32 compute), with the
same numpy inputs: the config, the init's leaves (``mm_proj`` among
them), ``forward`` logits with a random non-zero ``prefix_embeds`` and
text only, ``train_loss`` (the prefix's logits dropped) and its gradient
into the trainable tree, the prefill step, ``init_cache``, greedy decode
(text only, as the reference's ``generate``), a 2-round
``run_reduced_arch`` history, and ``flash_attention`` with a
bidirectional prefix at PaliGemma's head dim of 256.

Tolerances, the zoo's (``tests/test_torch_zoo.py``): init within 4 ulps
(threefry bits are JAX's; the erfinv rounds differently), zeros exact;
outputs from the reference's own weights in float32, the two packages
summing 256- to 1152-long dot products in other orders: logits and
losses rtol / atol 1e-4, each gradient leaf within 1e-4 of its largest
|entry|; the 2-round history's losses within rel 1e-4 and the trained y
by update norm within 1e-3 of JAX's update.
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
from repro.launch import specs as jspecs
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
ARCH = "paligemma-3b"
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


def _prefix(seed, B, P):
    return np.random.default_rng(seed).standard_normal(
        (B, P, tdlm.VISION_TOWER_DIM)).astype(np.float32)


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
    assert (full.family, full.num_prefix_tokens, full.resolved_head_dim,
            full.num_kv_heads) == ("vlm", 256, 256, 1)
    assert tbase.match_freeze("layers/slot0/ffn/wi_gate/kernel",
                              full.freeze_spec)
    assert not tbase.match_freeze("mm_proj/kernel", full.freeze_spec)
    assert tdlm.VISION_TOWER_DIM == jspecs.VISION_TOWER_DIM == 1152


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
    assert got["mm_proj/kernel"].shape == (1152, 256)
    assert got["mm_proj/kernel"].any()
    assert "unembed/kernel" not in got


@pytest.mark.parametrize("with_prefix", [True, False])
def test_forward_logits_match_jax(params, with_prefix):
    """Random non-zero patch embeddings (the positions run over prefix and
    text, the prefix seen from every query), or text alone."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    toks = _tokens(1, jcfg.vocab_size, 2, 12)
    jkw, tkw = {}, {}
    if with_prefix:
        pe = _prefix(2, 2, jcfg.num_prefix_tokens)
        jkw["prefix_embeds"] = jnp.asarray(pe)
        tkw["prefix_embeds"] = torch.from_numpy(pe)
    jl, _ = jdlm.forward(jp, jcfg, jnp.asarray(toks), **jkw)
    tl, _ = tdlm.forward(tp, tcfg, torch.from_numpy(toks), **tkw)
    assert tl.shape == (2, 12 + 8 * with_prefix, jcfg.vocab_size)
    _close(tl, jl)


def test_train_loss_and_gradient_match_jax(params):
    jcfg, tcfg = _cfgs()
    jp, tp = params
    toks = _tokens(2, jcfg.vocab_size, 2, 16)
    pe = _prefix(3, 2, jcfg.num_prefix_tokens)
    mask = (np.arange(16)[None, :] < np.array([[16], [11]])).astype(
        np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "mask": jnp.asarray(mask), "prefix_embeds": jnp.asarray(pe)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks),
          "mask": torch.from_numpy(mask),
          "prefix_embeds": torch.from_numpy(pe)}
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
    assert sorted(got) == sorted(want) and "mm_proj/kernel" in got
    for path, w in want.items():
        w = np.asarray(w)
        err = np.abs(got[path].numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)


def test_prefill_step_passes_the_prefix(params):
    """``make_prefill_step`` on the serving split takes the batch's
    ``prefix_embeds``, as the reference's does."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    toks = _tokens(4, jcfg.vocab_size, 2, 10)
    pe = _prefix(5, 2, jcfg.num_prefix_tokens)
    jy, jz = jpart.partition(jp, jcfg.freeze_spec)
    jz = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jz)
    want = jspecs.make_prefill_step(jcfg)(
        jy, jz, {"tokens": jnp.asarray(toks),
                 "prefix_embeds": jnp.asarray(pe)})
    y, z = tspecs.serving_split(tbasic.tree_map(lambda x: x, tp), tcfg)
    got = tspecs.make_prefill_step(tcfg, device="cpu")(
        y, z, {"tokens": toks, "prefix_embeds": pe})
    assert got.shape == (2, 18, jcfg.vocab_size)
    _close(got, want)


def test_init_cache_shapes_and_dtypes():
    jcfg, tcfg = _cfgs()
    jc = jdlm.init_cache(jcfg, 2, 24)
    tc = tdlm.init_cache(tcfg, 2, 24, device="cpu")
    want = dict(jbasic.flatten_params(jc["slots"]))
    got = dict(tbasic.flatten_params(tc["slots"]))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype)[6:] == str(w.dtype), path
        assert not got[path].any()
    assert "cross" not in tc and tc["cache_len"] == 0
    assert got["slot0/k"].shape == (2, 2, 24, 1, 64)


def test_greedy_decode_matches_jax(params):
    """Text-only greedy generation (the reference's ``generate``: no prefix
    in decode), 8 prompt tokens and 8 steps."""
    jcfg, tcfg = _cfgs()
    jp, tp = params
    prompt = _tokens(6, jcfg.vocab_size, 2, 8)
    want = np.asarray(jserve.generate(jp, jcfg, jnp.asarray(prompt), 8))
    got = tserve.generate(tp, tcfg, prompt, 8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    logits, _ = tserve.prefill_by_steps(tp, tcfg, prompt, 16, device="cpu")
    full, _ = tdlm.forward(tp, tcfg, torch.from_numpy(prompt))
    _close(logits, full.detach().numpy())


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                 "--steps", "4"])
    out = capsys.readouterr().out
    assert "generated (2, 12)" in out and "on cpu" in out


@pytest.mark.parametrize("window,causal", [(0, True), (20, True),
                                           (0, False)])
def test_flash_attention_with_a_prefix_matches_jax(window, causal):
    """PaliGemma's attention: 8 q heads over one kv head of 256, a 24-key
    bidirectional prefix before 40 text positions, chunks of 16 (a chunk
    straddles the prefix's edge), with a window ANDed on the prefix
    mask, and non-causal (the prefix then changes nothing)."""
    jcfg, tcfg = _cfgs(num_heads=8, num_kv_heads=1, head_dim=256,
                       sliding_window=window)
    rng = np.random.default_rng(7 + window)
    q, k, v = (rng.standard_normal((2, 64, h, 256)).astype(np.float32)
               for h in (8, 1, 1))
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jcfg, chunk=16,
                                 causal=causal, prefix_len=24)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tcfg, chunk=16,
                                causal=causal, prefix_len=24)
    _close(got, want, rtol=1e-5, atol=1e-5)
    if causal and window == 0:   # the prefix is seen: row 0 attends past 0
        plain = tattn.flash_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), tcfg, chunk=16)
        assert not torch.allclose(got[:, :24], plain[:, :24])


@pytest.fixture(scope="module")
def runs():
    jres, jcfg = jrun_reduced_arch(ARCH, 2, log=False)
    tres, tcfg = ttrain.run_reduced_arch(ARCH, 2, log=False, device="cpu")
    return jres, jcfg, tres, tcfg


def test_run_reduced_arch_matches_the_reference(runs):
    """2 rounds of FedPT with the reference's zero patch embeddings."""
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


@pytest.mark.parametrize("layers", [4, 8])
def test_mm_proj_bias_first_round_grows_with_depth_as_the_references(
        layers):
    """One FedPT round of the reduced config at ``layers`` layers with the
    reference's zero patch embeddings, in both packages. ``mm_proj``'s
    bias starts at 0, so every prefix row is 0 in every layer at the
    first step, each layer's RMSNorm passes its gradient with a gain of
    1 / sqrt(eps) = 1e3 there, and the bias's first step grows with depth
    (the 8 layers are the depth trained on the card): the port's trained
    bias within rel 1e-4 of the reference's by norm (in float64; float32's
    own norm overflows at 8 layers), and past 1e3 ** (layers / 2)."""
    from repro.core import fedpt as jfedpt
    from repro.data import synthetic as jsyn
    from repro.fl import runtime as jruntime
    from repro_torch.fl import runtime as truntime
    jcfg = jreduced(jget(ARCH), max_layers=layers)
    ds = jsyn.make_federated_tokens(16, 32, seq_len=32,
                                    vocab=jcfg.vocab_size, seed=0)

    def jloss(p, b):   # the reference's run_reduced_arch loss
        return jdlm.train_loss(p, jcfg, {
            "tokens": b["tokens"], "labels": b["tokens"],
            "prefix_embeds": jnp.zeros((b["tokens"].shape[0],
                                        jcfg.num_prefix_tokens, 1152))})
    jres = jruntime.run_federated(
        lambda s: jdlm.init_model(jcfg, s), jloss, ds,
        jfedpt.RoundConfig(4, 2, 4, "sgd", 0.1, "sgdm", 0.5), 1,
        freeze_spec=jcfg.freeze_spec, seed=0, data_kind="tokens")
    at = ttrain.arch_task(ttrain.reduced_config(tbase.get_config(ARCH),
                                                max_layers=layers), 0, "cpu")
    tres = truntime.run_federated(at.init_fn, at.loss_fn, at.dataset, at.rc,
                                  1, freeze_spec=at.cfg.freeze_spec, seed=0,
                                  data_kind="tokens", device="cpu")
    want = np.asarray(jres.y["mm_proj"]["bias"], np.float64)
    got = tres.y["mm_proj"]["bias"].double().numpy()
    top = float(np.abs(want).max())
    print(f"{layers} layers: mm_proj bias after one round, largest |entry| "
          f"{float(np.abs(got).max()):.6e} (reference {top:.6e})")
    np.testing.assert_allclose(tres.history[0]["loss"],
                               jres.history[0]["loss"], rtol=RTOL)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
    assert top > 1e3 ** (layers / 2)
