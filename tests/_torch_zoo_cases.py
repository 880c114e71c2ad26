"""The zoo's cases shared by its family files (``tests/test_torch_zoo.py``
and ``tests/test_torch_zoo_{moe,mla,hybrid,ssm}.py``), each on an
architecture's ``reduced_config`` against the JAX package: the stacked
init, ``forward`` logits and the MoE aux loss, ``train_loss`` and its
gradient into the trainable tree, one federated step. A family file sets
``FAMILY`` and imports the cases and ``pytest_generate_tests``, which
parametrizes them over it; the cases then run, and are named, per file.

Tolerances. Init: zeros exact, normals within 4 ulps (the threefry bits
are JAX's; torch's and XLA's erfinv round differently, as
``tests/test_torch_prng.py`` establishes). Outputs are computed from the
reference's own weights (carried across by the bridge) in float32; the
two packages sum 256- to 1024-long dot products in other orders, so
logits and losses of O(1) agree to rtol 1e-4 / atol 1e-4, each leaf's
gradient within 1e-4 of its largest |entry|. Training end to end (in the
MoE file): the two runs' losses within rel 1e-4 and the trained y by
update norm, ||dy_port - dy_jax|| <= 1e-3 ||dy_jax|| (two rounds of
float32 reassociation compound through SGD steps; measured ~1e-6).
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
from repro.launch.train import reduced_config as jreduced
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

load_all()
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


def _cfgs(arch, **kw):
    jcfg = jreduced(jget(arch)).with_(**kw)
    return jcfg, tbase.ModelConfig(**dataclasses.asdict(jcfg))


def _to_torch(tree):
    return bridge.from_numpy_tree(jax.tree_util.tree_map(np.asarray, tree),
                                  device="cpu")


_PARAMS = {}


def _params(arch):
    """(JAX params, the port's copy of them) of the arch's reduced config,
    made once per process."""
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


def pytest_generate_tests(metafunc):
    """Runs the cases defined here over the importing file's ``FAMILY``."""
    if metafunc.function.__module__ == __name__:
        metafunc.parametrize("arch", metafunc.module.FAMILY)


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
    if jcfg.num_experts:   # the first MoE slot's experts, stacked over groups
        slots, G = tdlm.layer_program(_cfgs(arch)[1])
        si = next(i for i, slot in enumerate(slots) if slot.use_moe)
        assert got[f"layers/slot{si}/moe/wi_gate"].shape == (G, 4, 256, 512)
    assert ("unembed/kernel" in got) != jcfg.tie_embeddings


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
