"""The Stack Overflow NWP task in the port against the JAX package, on the
CPU: the token data (the port's copy of ``data/synthetic.py`` gives the
reference's arrays, equal), ``nwp_accuracy_eval`` (equal), a short
``run_federated`` and an async int8 DP run of the SO transformer at
vocab 64, and the training CLI.

The federated runs follow ``tests/test_torch_grid.py``: the host side
(virtual clock, staleness, scheduler stats, wire bytes, DP summary)
exactly, and losses within rel 1e-5 (float32 training in another
framework). The clients train with SGD (``examples/dp_federated_lm.py``'s
client lr 10**-0.5), not ``train.py``'s Adam: Adam's first step is
g / (|g| + 1e-8), so an element whose gradient is float noise (the key
bias's, zero in exact arithmetic since softmax ignores a shift; 1e-10
apart in the two packages) steps by up to the learning rate with the
noise's sign, which no tolerance on y covers.

``y``, sync: within 2e-2 of the update by norm, ||y - y_ref|| <=
2e-2 ||y_ref - y_0||. An FFN pre-activation within the float32
reassociation noise of 0 (one lies at 2.3e-7 on a first-round batch
here) falls on the other side of the ReLU in the other package, which
moves that step's gradient by the unit's whole share: 2.2e-3 of a layer
norm's gradient, where the two packages' gradients otherwise agree, and
agree with a float64 one, to 1e-6. Two rounds of such flips leave the
runs 0.7e-2 apart by norm.

``y``, async int8 DP: elementwise within 1e-5 of max|y| plus one int8
step per update: a client value on a rounding boundary may flip by one
step, at most clip / 127 once clipped, which the fixed denominator
(weights <= 1) and ``server_lr`` pass on once per update.
"""
import re

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.core import fedpt as jfedpt
from repro.data import synthetic as jsyn
from repro.fl import runtime as jruntime
from repro.models import decoder_lm as jdlm
from repro.models import paper_models as jpm
from repro.sim import grid as jgrid
from repro_torch import bridge
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import flat as tflat
from repro_torch.core import partition as tpart
from repro_torch.data import synthetic as tsyn
from repro_torch.fl import runtime as truntime
from repro_torch.kernels import dp_clip, quantize
from repro_torch.launch import train as ttrain
from repro_torch.models import paper_models as tpm
from repro_torch.nn import basic as tbasic
from repro_torch.sim import grid as tgrid

VOCAB = 64
REL = 1e-5
Y_REL = 1e-5


def _equal_datasets(a, b):
    assert a.vocab == b.vocab
    assert len(a.client_tokens) == len(b.client_tokens)
    for x, y in zip(a.client_tokens, b.client_tokens):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.test_tokens, b.test_tokens)


@pytest.mark.parametrize("kw", [dict(num_clients=5, sentences_per_client=9,
                                     seq_len=7, vocab=50, seed=3),
                                dict(num_clients=3, sentences_per_client=4,
                                     test_sentences=16)])
def test_make_federated_tokens_equals_reference(kw):
    _equal_datasets(tsyn.make_federated_tokens(**kw),
                    jsyn.make_federated_tokens(**kw))


def test_cohort_batch_tokens_equals_reference():
    ds = tsyn.make_federated_tokens(6, 10, seq_len=5, vocab=40, seed=1)
    out = []
    for syn in (tsyn, jsyn):
        rng = np.random.default_rng(7)
        cids = syn.sample_cohort(rng, 6, 3)
        out.append(syn.cohort_batch(ds, cids, 2, 4, rng, kind="tokens"))
    (tb, tw), (jb, jw) = out
    assert tb["tokens"].shape == (3, 2, 4, 5)
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    np.testing.assert_array_equal(tw, jw)


@pytest.fixture(scope="module")
def jax_so():
    return jpm.init_so_transformer(0, vocab=VOCAB)


def test_nwp_accuracy_eval_equals_reference(jax_so):
    ds = tsyn.make_federated_tokens(2, 4, vocab=VOCAB, test_sentences=40,
                                    seed=2)
    want = jruntime.nwp_accuracy_eval(jpm.so_transformer_forward,
                                      ds.test_tokens, batch=16)(jax_so)
    got = truntime.nwp_accuracy_eval(tpm.so_transformer_forward,
                                     ds.test_tokens, batch=16)(
        bridge.from_numpy_tree(jax_so, "cpu"))
    assert got == want
    assert set(got) == {"accuracy"}


def _jax_loss(params, b):
    logits = jpm.so_transformer_forward(params, b["tokens"])
    return jdlm.lm_loss(logits[:, :-1], b["tokens"][:, 1:]), {}


def _run_both(jax_so, rc_kw, grid_kw, rounds, spec):
    ds = tsyn.make_federated_tokens(8, 12, vocab=VOCAB, test_sentences=16,
                                    seed=0)
    # the reference's round donates its inputs: each run gets a copy
    host = jax.tree_util.tree_map(np.asarray, jax_so)
    jres = jgrid.run_grid(lambda s: jax.tree_util.tree_map(jnp.array, host),
                          _jax_loss, ds, jfedpt.RoundConfig(**rc_kw), rounds,
                          grid=jgrid.GridConfig(**grid_kw),
                          freeze_spec=spec, seed=0, data_kind="tokens")
    tres = tgrid.run_grid(lambda s: bridge.from_numpy_tree(host, "cpu"),
                          ttrain.token_loss(tpm.so_transformer_forward), ds,
                          tfedpt.RoundConfig(**rc_kw), rounds,
                          grid=tgrid.GridConfig(**grid_kw), freeze_spec=spec,
                          seed=0, data_kind="tokens", device="cpu")
    return jres, tres


def _check(jres, tres, y_tol=0.0, norm_rel=None):
    assert len(tres.history) == len(jres.history)
    for hj, ht in zip(jres.history, tres.history):
        assert set(ht) == set(hj)
        for k, v in hj.items():
            if k in ("loss", "delta_norm"):
                assert abs(ht[k] - v) <= REL * abs(v) + y_tol, k
            else:
                assert ht[k] == v, k
    assert tres.virtual_seconds == jres.virtual_seconds
    assert tres.scheduler_stats == jres.scheduler_stats
    for f in ("measured_down_bytes", "measured_up_bytes", "transfers",
              "full_bytes", "trainable_bytes"):
        assert getattr(tres.comm, f) == getattr(jres.comm, f), f
    assert tres.dp == jres.dp
    want = {k: np.asarray(v) for k, v in tbasic.flatten_params(jres.y)}
    got = {k: v.numpy() for k, v in tbasic.flatten_params(tres.y)}
    assert sorted(got) == sorted(want)
    if norm_rel is not None:
        y0 = {k: np.asarray(v) for k, v in tbasic.flatten_params(
            jpm.init_so_transformer(0, vocab=VOCAB))}
        diff = sum(float(((got[k] - w) ** 2).sum()) for k, w in want.items())
        step = sum(float(((w - y0[k]) ** 2).sum()) for k, w in want.items())
        assert diff ** 0.5 <= norm_rel * step ** 0.5
        return
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=Y_REL * scale + y_tol, err_msg=k)


SGD_CLIENT = dict(client_opt="sgd", client_lr=10 ** -0.5)


def test_run_federated_so_sync_matches_jax(jax_so):
    rc_kw = dict(clients_per_round=4, local_steps=2, local_batch=4,
                 server_opt="sgd", server_lr=0.03, **SGD_CLIENT)
    spec = tpm.so_freeze_spec((0, 1, 2))
    jres, tres = _run_both(jax_so, rc_kw, {}, 2, spec)
    _check(jres, tres, norm_rel=2e-2)
    assert tres.history[-1]["loss"] < tres.history[0]["loss"] + 1.0


def test_async_int8_dp_so_matches_jax(jax_so):
    clip, server_lr, updates = 0.5, 0.03, 2
    rc_kw = dict(clients_per_round=4, local_steps=2, local_batch=4,
                 server_opt="sgd", server_lr=server_lr, **SGD_CLIENT,
                 uplink_bits=8, dp_clip_norm=clip,
                 dp_noise_multiplier=0.4)
    grid_kw = dict(mode="async", fleet="pareto-mobile", concurrency=4,
                   goal_count=2, staleness="polynomial")
    spec = tpm.so_freeze_spec((0, 1, 2))
    # the lane's rows take the two-pass Q->DQ and the three-launch clip on
    # the card; here both run through their plain versions
    y, _ = tpart.partition(bridge.from_numpy_tree(
        jax.tree_util.tree_map(np.asarray, jax_so), "cpu"), spec)
    layout = tflat.FlatLayout.of(y)
    assert quantize.qdq_route(layout.size, 1024, len(layout.sizes)) \
        == "two_pass"
    assert dp_clip.clip_route(layout.size) == "three_launch"
    jres, tres = _run_both(jax_so, rc_kw, grid_kw, updates, spec)
    _check(jres, tres, updates * server_lr * clip / 127)
    assert tres.dp["flushes"] == updates


def test_train_cli_runs_the_so_task_on_the_cpu(capsys):
    ttrain.main(["--task", "stackoverflow", "--rounds", "1", "--device",
                 "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"final loss=\d+\.\d{4} comm reduction=\d+\.\dx "
                        r"sec/round=(\d+\.\d\d|nan)", out[-1]), out[-1]
    assert any(line.startswith("  round 0: loss=") and "accuracy=" in line
               for line in out)
    for arch in ("paligemma-3b", "whisper-large-v3", "xlstm-350m"):
        ttrain.main(["--arch", arch, "--reduced", "--rounds", "1",
                     "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert any(line.startswith(f"arch={arch} trainable share: ")
                   for line in out)
        assert re.fullmatch(r"final loss=\d+\.\d{4} comm reduction="
                            r"\d+\.\dx sec/round=(\d+\.\d\d|nan)",
                            out[-1]), out[-1]
