"""The two faults repaired together with the round-once attention mode,
on the CPU, against the JAX package:

* ``nn/threefry.split`` and ``randint`` draw ``jax.random``'s bits
  (partitionable mode), and the serve CLI draws the reference's prompt;
* the port's chunked attention at 64-key chunks (the plain version of the
  card's ``flash_attention``) against the reference's ``flash_attention``
  at its chunk of 512, within bound (ii).

Bound (ii). Both compute the reference's function: float32 scores and
online softmax, p rounded to v's dtype before p.v, l summing the float32
p. They round each p at a different running max where the max moved
between the end of its 64-key chunk and the end of its 512-key chunk, so
the two roundings of the same p differ. A rounding to nearest is within
u = 2**-8 (bf16) of p, relative; the two are within 2 u p_j of each
other, so the outputs differ by at most 2 u sum_j p_j |v_j| / l (p and l
at the final max), at most 2 u max |v| over the visible keys. Each side
then rounds its output once: u (|a| + |b|). The float32 quantities
(scores, exp, the sums) differ by the order of the sums, ~1e-6: 1e-5
absolute. The test computes sum_j p_j |v_j| / l densely in float64.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets jax_threefry_partitionable)
import jax
import jax.numpy as jnp

from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch.train import reduced_config as jreduced
from repro.nn import attention as jattn
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import serve as tserve
from repro_torch.nn import attention as tattn
from repro_torch.nn import threefry

SEEDS = (0, 1, 42, 2**31 + 5, -3)
SHAPES = ((), (1,), (7,), (3, 5), (2, 3, 4), (1001,))
# spans: a power of two, the NeMo vocabulary, a non-power of two above
# 2**16 (the high draw drops out), a small odd one, and near 2**31 / 2**32
SPANS = ((0, 1024), (0, 131072), (3, 1_000_003), (-7, 100),
         (0, 2**31 - 1), (-2**31, 2**31 - 1), (5, 5))


def _key_data(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 8])
def test_split_matches_jax(seed, num):
    jk = jax.random.fold_in(jax.random.key(seed), 7)
    tk = threefry.fold_in(threefry.key(seed), 7)
    want = [_key_data(k) for k in jax.random.split(jk, num)]
    assert threefry.split(tk, num) == want
    # and a split of a split
    assert threefry.split(threefry.split(tk, num)[-1]) == [
        _key_data(k) for k in jax.random.split(jax.random.split(jk, num)[-1])]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", SPANS)
def test_randint_matches_jax_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
    got = threefry.randint(threefry.key(seed), shape, lo, hi)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 2**31), (-2**31 - 1, 5)])
def test_randint_refuses_bounds_outside_int32(lo, hi):
    with pytest.raises(OverflowError):      # JAX refuses them too
        jax.random.randint(jax.random.key(0), (3,), lo, hi)
    with pytest.raises(ValueError, match="int32"):
        threefry.randint(threefry.key(0), (3,), lo, hi)


def _captured_prompt(serve_module, run, monkeypatch):
    """The prompt ``main`` hands to ``generate``, with generation itself and
    the model's init stubbed out."""
    seen = {}

    def fake_generate(params, cfg, prompt, steps, **kw):
        seen["prompt"] = np.asarray(prompt)
        time.sleep(0.01)       # main divides by the elapsed time
        return prompt
    monkeypatch.setattr(serve_module, "generate", fake_generate)
    monkeypatch.setattr(serve_module.dlm, "init_model", lambda *a, **k: None)
    run()
    return seen["prompt"]


@pytest.mark.parametrize("argv", [[], ["--batch", "3", "--prompt-len", "5"]])
def test_serve_cli_draws_the_reference_prompt(argv, monkeypatch, capsys):
    """``repro_torch.launch.serve.main`` draws ``jax.random.randint(jax.random
    .key(1), (batch, prompt_len), 0, vocab)``, as ``repro.launch.serve.main``
    does: the CLI's defaults, and another batch and length."""
    arch = ["--arch", "mistral-nemo-12b"]
    want = _captured_prompt(jserve, lambda: jserve.main(arch + argv),
                            monkeypatch)
    got = _captured_prompt(
        tserve, lambda: tserve.main(arch + argv + ["--device", "cpu"]),
        monkeypatch)
    capsys.readouterr()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    batch = 3 if argv else 4
    assert want.shape == (batch, 5 if argv else 8)


def _cfgs(window):
    jcfg = jreduced(jget("mistral-nemo-12b")).with_(num_kv_heads=2,
                                                     sliding_window=window)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _pv_weight(q, k, v, window):
    """sum_j p_j |v_j| / l per output element, dense in float64, q (b, s,
    h, d), k and v (b, s, kvh, d); causal, with the window."""
    rep = q.shape[2] // k.shape[2]
    qd = q.double().transpose(1, 2)
    kd = k.double().transpose(1, 2).repeat_interleave(rep, 1)
    vd = v.double().transpose(1, 2).repeat_interleave(rep, 1)
    S = q.shape[1]
    pos = torch.arange(S)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    s = torch.einsum("bhqd,bhkd->bhqk", qd, kd) / np.sqrt(q.shape[3])
    p = torch.softmax(s.masked_fill(~mask, -np.inf), -1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vd.abs()).transpose(1, 2)


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("S", [200, 1100])
def test_chunk64_attention_matches_jax_within_bound_ii(window, S):
    """The port's ``chunked_attention(chunk=64)`` (the function the card's
    ``flash_attention`` computes) against the reference's
    ``flash_attention`` at its chunk of 512, bf16, GQA rep 2; S = 1100
    spans three 512-key chunks."""
    jcfg, tcfg = _cfgs(window)
    rng = np.random.default_rng(S + window)
    q, k, v = (rng.standard_normal((1, S, h, 64)).astype(np.float32)
               for h in (4, 2, 2))
    want = np.asarray(jattn.flash_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jcfg), np.float32)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = tattn.chunked_attention(qt, kt, vt, tcfg, chunk=64)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    u = 2.0 ** -8
    bound = (2 * u * _pv_weight(qt, kt, vt, window).numpy()
             + u * (np.abs(got) + np.abs(want)) + 1e-5)
    err = np.abs(got - want)
    assert np.all(err <= bound), float((err / bound).max())
    # the chunk moves roundings: the two are not the same bits
    assert np.any(got != want)
