"""The port's attention (``repro_torch/nn/attention.py``) and the plain
sliding-window attention (``repro_torch/kernels/ref.py``) against the JAX
package: RoPE, the q/k/v projections, the chunked flash attention at
windows 0, 16 and 100 with GQA and an S that is not a multiple of the
chunk, decode attention on a wrapped ring, and the dense oracle against
the reference's and against the Pallas kernel in interpret mode.

Tolerances. float32 throughout: the two packages sum the same products
in other orders (XLA:CPU's dot and reductions against torch's), which
moves a score or an output by a few ulps of the largest term; outputs
are O(1), so rtol 1e-5 / atol 1e-5 (about 80 ulps) holds with margin.
RoPE: the angles go through float32 ``pow`` and ``cos`` / ``sin`` of two
libraries (1-2 ulps each), at angles up to 40 rad, so atol 2e-5.
The bf16 case rounds the output to bf16 in both: one bf16 ulp (2**-8
relative).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax.numpy as jnp

from repro.configs.base import get_config as jget
from repro.kernels import ref as jref
from repro.kernels.swa_attention import swa_attention as pallas_swa
from repro.launch.train import reduced_config as jreduced
from repro.nn import attention as jattn
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.nn import attention as tattn

RTOL = ATOL = 1e-5


def _cfgs(window=0, kv_heads=2):
    jcfg = jreduced(jget("mistral-nemo-12b")).with_(num_kv_heads=kv_heads,
                                                     sliding_window=window)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def test_rope_matches_jax():
    pos = np.arange(40)[None, :]
    jc, js = jattn.rope_freqs(64, 1e6, jnp.asarray(pos))
    tc, ts = tattn.rope_freqs(64, 1e6, torch.from_numpy(pos))
    _close(tc, jc, atol=2e-5)
    _close(ts, js, atol=2e-5)
    x = _rand(np.random.default_rng(0), 2, 40, 4, 64)
    want = jattn.apply_rope(jnp.asarray(x), jc, js)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                           torch.from_numpy(np.array(js)))
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_qkv_project_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(1)
    d, hd = jcfg.d_model, jcfg.resolved_head_dim
    p = {n: {"kernel": _rand(rng, d, h * hd) / np.sqrt(d)}
         for n, h in (("wq", 4), ("wk", 2), ("wv", 2))}
    x = _rand(rng, 2, 24, d)
    want = jattn.qkv_project(jnp.asarray(x), p, jcfg)
    got = tattn.qkv_project(torch.from_numpy(x),
                            {n: {"kernel": torch.from_numpy(v["kernel"])}
                             for n, v in p.items()}, tcfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("window", [0, 16, 100])
@pytest.mark.parametrize("S", [128, 600])
def test_flash_attention_matches_jax(window, S):
    """GQA rep 2; S = 600 leaves a ragged second chunk of 512."""
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(S + window)
    q, k, v = _rand(rng, 2, S, 4, 64), _rand(rng, 2, S, 2, 64), _rand(rng, 2, S, 2, 64)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jcfg)
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), tcfg)
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_flash_attention_bf16_matches_jax():
    jcfg, tcfg = _cfgs(16)
    rng = np.random.default_rng(3)
    q, k, v = (_rand(rng, 1, 200, 4, 64), _rand(rng, 1, 200, 2, 64),
               _rand(rng, 1, 200, 2, 64))
    want = jattn.flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                 jcfg)
    got = tattn.flash_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                                tcfg)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), rtol=2.0 ** -8, atol=1e-3)


@pytest.mark.parametrize("cache_len", [7, 16])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_on_a_wrapped_ring(cache_len, window):
    """A 16-slot ring whose write index has wrapped (the newest entry at
    slot 3); cache_len counts the valid slots, as decode_step passes it."""
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(cache_len)
    q = _rand(rng, 2, 1, 4, 64)
    kc, vc = _rand(rng, 2, 16, 2, 64), _rand(rng, 2, 16, 2, 64)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), cache_len, jcfg)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), cache_len, tcfg)
    _close(got, want)
    # a per-row cache_len
    cl = np.array([cache_len, 3], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(cl), jcfg)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc), torch.from_numpy(cl), tcfg)
    _close(got, want)


@pytest.mark.parametrize("window,causal", [(0, True), (50, True), (50, False),
                                           (0, False)])
def test_swa_ref_matches_the_jax_oracle(window, causal):
    rng = np.random.default_rng(window)
    q, k, v = (_rand(rng, 2, 4, 200, 64) for _ in range(3))
    want = jref.swa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window, causal)
    got = ref.swa_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window, causal, q_chunk=64)
    _close(got, want)


@pytest.mark.parametrize("S,window", [(256, 100), (200, 100), (200, 0),
                                      (256, 64)])
def test_swa_ref_matches_the_pallas_kernel(S, window):
    """bq = bk = 64; a window of 100 leaves rows whose first live tile is
    wholly masked (the exp(0) rubbish the next live score wipes out)."""
    rng = np.random.default_rng(S + window)
    q, k, v = (_rand(rng, 1, 2, S, 64) for _ in range(3))
    want = pallas_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      window=window, bq=64, bk=64, interpret=True)
    got = ref.swa_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), window)
    _close(got, want)


def test_swa_wrapper_on_cpu_is_the_plain_version_with_gqa():
    """The CPU path of ``ops.swa_attention``: kv head h // rep serves q
    head h (``jnp.repeat``), the output in q's dtype, ``out`` filled."""
    rng = np.random.default_rng(5)
    q, k, v = _rand(rng, 1, 8, 130, 64), _rand(rng, 1, 2, 130, 64), _rand(rng, 1, 2, 130, 64)
    want = jref.swa_attention_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 4, 1),
                                  jnp.repeat(jnp.asarray(v), 4, 1), 30)
    out = torch.empty((1, 8, 130, 64))
    got = ops.swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), window=30, out=out)
    assert got is out
    _close(got, want)
    b = ops.swa_attention(torch.from_numpy(q).bfloat16(),
                          torch.from_numpy(k).bfloat16(),
                          torch.from_numpy(v).bfloat16(), window=30)
    assert b.dtype == torch.bfloat16


def test_visible_pairs_counts_the_mask():
    from repro_torch.kernels import swa_attention as swa
    for S, w, causal in ((100, 0, True), (100, 30, True), (100, 30, False),
                         (64, 0, False)):
        qp, kp = np.arange(S)[:, None], np.arange(S)[None, :]
        mask = (qp >= kp) if causal else np.ones((S, S), bool)
        if w > 0:
            mask &= qp - kp < w
        assert swa.visible_pairs(S, w, causal) == int(mask.sum())
    # the serving path's counts per head
    assert swa.visible_pairs(32768, 0) == 536_887_296
    assert swa.visible_pairs(32768, 8192) == 234_885_120


def test_card_path_refuses_what_the_kernel_does_not_compute():
    """A tensor off the CPU takes the kernel's path; features the kernel
    does not compute (softcapping, an offset q) take the plain
    ``chunked_attention`` on the tensors' device instead, before any
    launch (meta tensors stand in for the card here: the wrapper, which
    refuses them, is never reached). A v head dim unlike q's (MLA), a
    bidirectional prefix (the VLM) and a non-causal call with other rows
    in q than in k (cross-attention) are the kernel's: they reach the
    wrapper."""
    _, tcfg = _cfgs()
    q = torch.empty((1, 64, 4, 64), device="meta")
    k = torch.empty((1, 64, 2, 64), device="meta")
    cases = [(tcfg.with_(attn_logit_softcap=30.0), q, k, k, {}),
             (tcfg, q, k, k, {"q_offset": 4})]
    for cfg, qq, kk, vv, kw in cases:
        out = tattn.flash_attention(qq, kk, vv, cfg, **kw)
        assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, k, k, tcfg, prefix_len=8)
    kx = torch.empty((1, 100, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, kx, kx, tcfg, causal=False)
    # and the kernel's wrapper refuses a tensor that is not on the card
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, k, k, tcfg)
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(q, k, torch.empty((1, 64, 2, 32),
                                                device="meta"), tcfg)
