"""The port's MoE layer (``repro_torch/nn/moe.py``) against the JAX
package's (``repro/nn/moe.py``) and against its own dense oracle.

Inputs come from numpy seeds; the expert weights are the reference's,
carried across by the bridge. Tolerances, float32 throughout:
- the four cases of ``tests/test_moe.py`` keep their bounds (the sort
  dispatch against the dense oracle at rtol 2e-4 / atol 2e-5, the aux
  loss at rtol 1e-5);
- against JAX, outputs of O(1) at rtol / atol 1e-5 (the einsums sum 32-
  to 64-long products in other orders), the aux loss at rtol 1e-6, the
  dropped tokens' rows exactly zero in both;
- under ``vmap(grad_and_value)``, the loss (a sum of 512 products of
  O(1)) at rtol 1e-5 / atol 1e-4 and the gradients at rtol 1e-4 / atol
  1e-6 (the backward sums the same products in other orders again);
- routing: ``torch.topk`` and ``jax.lax.top_k`` may order a near-tie
  differently, so expert ids are held equal on every token whose sorted
  probabilities are more than 1e-6 apart at each of the k boundaries,
  and the count of tokens inside the margin is printed;
- the dispatch buffer and, given equal expert outputs, the combine at
  k = 2 bit for bit.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.configs.base import ModelConfig as JConfig
from repro.nn import moe as jmoe
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.nn import moe as tmoe

CFG = JConfig(name="m", family="moe", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=8,
              num_experts=4, num_experts_per_tok=2,
              moe_capacity_factor=8.0,  # high capacity: no drops
              compute_dtype="float32")
MARGIN = 1e-6


def _twin(jcfg):
    return TConfig(**dataclasses.asdict(jcfg))


def _params(jcfg):
    jp = jmoe.init_moe(0, "moe", jcfg, jnp.float32)
    return jp, bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, jp),
                                      device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _clear_tokens(probs, k: int) -> np.ndarray:
    """Tokens whose sorted probabilities differ by more than MARGIN at
    each of the first k boundaries (so top-k's set and order are
    unambiguous)."""
    s = -np.sort(-np.asarray(probs), axis=-1)
    gaps = s[:, :k] - s[:, 1:k + 1]
    return (gaps > MARGIN).all(-1)


# --- the four cases of tests/test_moe.py, on the port alone ---------------


def test_moe_matches_dense_oracle_when_no_drops():
    cfg = _twin(CFG)
    p = tmoe.init_moe(0, "moe", cfg, torch.float32, device="cpu")
    x = torch.from_numpy(_x(1, 64, 32))
    got, aux1 = tmoe.moe_ffn(x, p, cfg)
    want, aux2 = tmoe.moe_ffn_dense_fallback(x, p, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)


def test_moe_with_shared_experts():
    cfg = _twin(CFG.with_(num_shared_experts=1, moe_d_ff=32))
    p = tmoe.init_moe(0, "moe", cfg, torch.float32, device="cpu")
    assert set(p["shared"]) == {"wi_gate", "wi_up", "wo"}
    x = torch.from_numpy(_x(2, 32, 32))
    got, _ = tmoe.moe_ffn(x, p, cfg)
    want, _ = tmoe.moe_ffn_dense_fallback(x, p, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_capacity_drop_reduces_output_not_crashes():
    cfg = _twin(CFG.with_(moe_capacity_factor=0.25))  # heavy dropping
    p = tmoe.init_moe(0, "moe", cfg, torch.float32, device="cpu")
    x = torch.from_numpy(_x(3, 64, 32))
    got, _ = tmoe.moe_ffn(x, p, cfg)
    assert got.shape == x.shape and bool(torch.isfinite(got).all())
    # dropped tokens -> some outputs exactly zero (no expert contribution)
    assert float(got.norm(dim=-1).min()) == 0.0


def test_router_weights_normalized_topk():
    cfg = _twin(CFG)
    p = tmoe.init_moe(0, "moe", cfg, torch.float32, device="cpu")
    w, idx, aux = tmoe.router_topk(torch.from_numpy(_x(4, 16, 32)), p, cfg)
    assert w.shape == (16, 2) and idx.shape == (16, 2)
    assert idx.dtype == torch.int32 and aux.dtype == torch.float32
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(idx.min()) >= 0 and int(idx.max()) < 4
    assert bool((idx[:, 0] != idx[:, 1]).all())
    assert float(aux) > 0


# --- against the JAX package ----------------------------------------------


def test_init_matches_jax():
    jp, _ = _params(CFG.with_(num_shared_experts=1))
    tp = tmoe.init_moe(0, "moe", _twin(CFG.with_(num_shared_experts=1)),
                       torch.float32, device="cpu")
    want = dict(jax.tree_util.tree_leaves_with_path(jp))
    assert len(want) == 7
    for path, w in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == w.shape
        ulps = np.abs(_bits(node.numpy()).astype(np.int64)
                      - _bits(w).astype(np.int64)).max()
        assert ulps <= 4, path   # erfinv rounds differently (test_torch_prng)


def test_router_topk_matches_jax():
    jp, tp = _params(CFG)
    x = _x(5, 256, 32)
    jw, jidx, jaux = jmoe.router_topk(jnp.asarray(x), jp, CFG)
    tw, tidx, taux = tmoe.router_topk(torch.from_numpy(x), tp, _twin(CFG))
    probs = jax.nn.softmax(x @ np.asarray(jp["router"]["kernel"]), axis=-1)
    clear = _clear_tokens(probs, 2)
    print(f"router: {int((~clear).sum())} of {len(clear)} tokens within "
          f"{MARGIN} of a tie")
    assert clear.sum() >= 0.9 * len(clear)
    np.testing.assert_array_equal(tidx.numpy()[clear], np.asarray(jidx)[clear])
    np.testing.assert_allclose(tw.numpy()[clear], np.asarray(jw)[clear],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("case", [
    dict(moe_capacity_factor=8.0),                         # no drops
    dict(moe_capacity_factor=0.25),                        # heavy drops
    dict(moe_capacity_factor=1.25, moe_dispatch_groups=2),  # grouped
    dict(moe_capacity_factor=1.25, num_shared_experts=1),
], ids=["no_drops", "drops", "grouped", "shared"])
def test_moe_ffn_matches_jax(case):
    jcfg = CFG.with_(**case)
    jp, tp = _params(jcfg)
    x = _x(6, 64, 32)
    jo, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
    to, taux = tmoe.moe_ffn(torch.from_numpy(x), tp, _twin(jcfg))
    # whole outputs agree only where routing is unambiguous: a flipped
    # near-tie moves its token (and, under drops, the ranks after it)
    probs = jax.nn.softmax(x @ np.asarray(jp["router"]["kernel"]), axis=-1)
    clear = _clear_tokens(probs, 2)
    print(f"moe_ffn: {int((~clear).sum())} of {len(clear)} tokens within "
          f"{MARGIN} of a tie")
    assert clear.all()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    zero_t = (to.norm(dim=-1) == 0).numpy()
    np.testing.assert_array_equal(zero_t,
                                  np.linalg.norm(np.asarray(jo), axis=-1) == 0)
    if case["moe_capacity_factor"] < 1:
        assert zero_t.sum() > 0


def test_dispatch_and_combine_bit_for_bit():
    """Given the same (w, idx), the port's buffer is the reference's bit
    for bit; given the same expert outputs, so is the combine (k = 2)."""
    jcfg = CFG.with_(moe_capacity_factor=1.0)
    jp, _ = _params(jcfg)
    T, e, k = 48, 4, 2
    x = _x(7, T, 32)
    jw, jidx, _ = jmoe.router_topk(jnp.asarray(x), jp, jcfg)
    cap = tmoe.capacity(T, _twin(jcfg))
    assert cap == int(max(1, round(T * k / e * 1.0)))
    jbuf, jmeta = jmoe._sort_dispatch(jnp.asarray(x), jw, jidx, e, cap,
                                      jnp.float32)
    tw, tidx = (torch.from_numpy(np.array(a)) for a in (jw, jidx))
    tbuf, tmeta = tmoe._sort_dispatch(torch.from_numpy(x), tw, tidx, e, cap,
                                      torch.float32)
    np.testing.assert_array_equal(_bits(tbuf.numpy()), _bits(jbuf))
    assert not bool(tmeta[1].all())   # capacity 1.0 drops some entries
    y = _x(8, e * cap, 32)
    jout = jmoe._combine_local(jnp.asarray(y), jmeta, T, e, cap, jnp.float32)
    tout = tmoe._combine_local(torch.from_numpy(y), tmeta, T, e, cap,
                               torch.float32)
    np.testing.assert_array_equal(_bits(tout.numpy()), _bits(jout))


@pytest.mark.filterwarnings("error")
@pytest.mark.parametrize("groups", [0, 2])
def test_vmapped_grad_matches_jax(groups):
    """``moe_ffn`` under ``torch.func.vmap(grad_and_value)`` over 3
    clients (the round engine's form) against ``jax.vmap(value_and_grad)``,
    every leaf's gradient (the router's included); a vmap fallback's
    "performance drop" warning fails the test."""
    jcfg = CFG.with_(moe_capacity_factor=1.25, moe_dispatch_groups=groups)
    tcfg = _twin(jcfg)
    jp, tp = _params(jcfg)
    xs, r = _x(9, 3, 16, 32), _x(10, 16, 32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(x, p, jcfg)
        return jnp.sum(out * r) + 0.02 * aux

    def tloss(p, x):
        out, aux = tmoe.moe_ffn(x, p, tcfg)
        return (out * torch.from_numpy(r)).sum() + 0.02 * aux

    jv, jg = jax.vmap(jax.value_and_grad(jloss), in_axes=(None, 0))(
        jp, jnp.asarray(xs))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tg, tv = torch.func.vmap(torch.func.grad_and_value(tloss),
                                 in_dims=(None, 0))(tp, torch.from_numpy(xs))
    # each value sums 512 products of O(1), some cancelling
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-4)
    assert float(tg["router"]["kernel"].abs().max()) > 0
    for path, w in jax.tree_util.tree_leaves_with_path(jg):
        node = tg
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))
