"""Two synchronous FedPT rounds of the port against the JAX package.

A narrow CNN of the EMNIST structure (conv 5x5 with 4 then 8 channels,
GroupNorm, dense 16, 62 classes), built in this file from each package's
primitives so that JAX's jit stays short; 3 clients x 2 local SGD steps,
at ``uplink_bits`` 0 and 8, on the same data (the port's copy of
``data/synthetic.py``, held identical to the reference's) and the same
parameters (the reference's, carried across by ``repro_torch.bridge``).
One more pair of runs trains every parameter under int8 DP-FedAvg with
the quarantine screen, forced onto the fused tail.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.core import fedpt as jfedpt
from repro.core import sanitize as jsan
from repro.data import synthetic as jsyn
from repro.nn import basic as jbasic
from repro.nn import conv as jconv
from repro_torch import bridge
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import flat as tflat
from repro_torch.core import partition as tpart
from repro_torch.core import sanitize as tsan
from repro_torch.data import synthetic as tsyn
from repro_torch.nn import basic as tbasic
from repro_torch.nn import conv as tconv
from repro_torch.nn import threefry

FREEZE = (r"^dense1/",)
ROUNDS, CLIENTS, STEPS, BATCH = 2, 3, 2, 8
SERVER_LR = 0.5


def jax_init(seed):
    f32 = jnp.float32
    return {"conv1": jconv.init_conv(seed, "conv1", 5, 1, 4, f32),
            "conv2": jconv.init_conv(seed, "conv2", 5, 4, 8, f32),
            "gn": jconv.init_groupnorm(seed, "gn", 8, f32),
            "dense1": jbasic.init_dense(seed, "dense1", 392, 16, f32, True),
            "dense2": jbasic.init_dense(seed, "dense2", 16, 62, f32, True)}


def torch_init(seed):
    kw = dict(device="cpu")
    return {"conv1": tconv.init_conv(seed, "conv1", 5, 1, 4, **kw),
            "conv2": tconv.init_conv(seed, "conv2", 5, 4, 8, **kw),
            "gn": tconv.init_groupnorm(seed, "gn", 8, **kw),
            "dense1": tbasic.init_dense(seed, "dense1", 392, 16, bias=True,
                                        **kw),
            "dense2": tbasic.init_dense(seed, "dense2", 16, 62, bias=True,
                                        **kw)}


def jax_loss(params, batch):
    x = jconv.conv2d(batch["images"], params["conv1"])
    x = jconv.maxpool2d(jax.nn.relu(x))
    x = jconv.conv2d(x, params["conv2"])
    x = jax.nn.relu(jconv.apply_groupnorm(x, params["gn"], groups=2))
    x = jconv.maxpool2d(x)
    x = x.reshape(x.shape[0], -1)
    x = jax.nn.relu(jbasic.dense(x, params["dense1"]))
    lp = jax.nn.log_softmax(jbasic.dense(x, params["dense2"]))
    return -jnp.mean(jnp.take_along_axis(lp, batch["labels"][:, None], 1)), {}


def torch_loss(params, batch):
    x = tconv.conv2d(batch["images"], params["conv1"])
    x = tconv.maxpool2d(torch.relu(x))
    x = tconv.conv2d(x, params["conv2"])
    x = torch.relu(tconv.apply_groupnorm(x, params["gn"], groups=2))
    x = tconv.maxpool2d(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(tbasic.dense(x, params["dense1"]))
    lp = torch.log_softmax(tbasic.dense(x, params["dense2"]), -1)
    return -lp.gather(1, batch["labels"].long()[:, None]).mean(), {}


def _data(pkg):
    return pkg.make_federated_images(num_clients=6, examples_per_client=20,
                                     shape=(28, 28, 1), num_classes=62,
                                     alpha=1.0, test_examples=16, seed=3)


def _cohorts(pkg, ds):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(ROUNDS):
        cids = pkg.sample_cohort(rng, ds.num_clients, CLIENTS)
        out.append(pkg.cohort_batch(ds, cids, STEPS, BATCH, rng))
    return out


def test_synthetic_copy_is_identical():
    jds, tds = _data(jsyn), _data(tsyn)
    assert jds.num_clients == tds.num_clients and \
        jds.num_classes == tds.num_classes
    for a, b in zip(jds.client_images + jds.client_labels
                    + [jds.test_images, jds.test_labels],
                    tds.client_images + tds.client_labels
                    + [tds.test_images, tds.test_labels]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for (jb, jw), (tb, tw) in zip(_cohorts(jsyn, jds), _cohorts(tsyn, tds)):
        np.testing.assert_array_equal(jw, tw)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])


def test_narrow_init_matches_jax():
    want = dict(jbasic.flatten_params(jax_init(0)))
    got = dict(tbasic.flatten_params(torch_init(0)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _run_jax(bits, cohorts):
    rc = jfedpt.RoundConfig(clients_per_round=CLIENTS, local_steps=STEPS,
                            local_batch=BATCH, client_lr=0.05,
                            server_lr=SERVER_LR, uplink_bits=bits)
    y, frozen = jpart.partition(jax_init(0), FREEZE)
    round_fn, sopt = jfedpt.make_round_fn(jax_loss, rc)
    round_fn = jax.jit(round_fn)
    st = sopt.init(y)
    hist = []
    for r, (batch, w) in enumerate(cohorts):
        y, st, m = round_fn(y, st, frozen, batch, jnp.asarray(w),
                            jax.random.key(r))
        hist.append((float(m["loss"]), float(m["delta_norm"])))
    return hist, jax.device_get(y)


def _run_torch(bits, cohorts):
    rc = tfedpt.RoundConfig(clients_per_round=CLIENTS, local_steps=STEPS,
                            local_batch=BATCH, client_lr=0.05,
                            server_lr=SERVER_LR, uplink_bits=bits)
    y, frozen = tpart.partition(bridge.from_numpy_tree(
        jax.device_get(jax_init(0)), "cpu"), FREEZE)
    round_fn, sopt = tfedpt.make_round_fn(torch_loss, rc, device="cpu")
    st = sopt.init(y)
    hist = []
    for batch, w in cohorts:
        y, st, m = round_fn(y, st, frozen, batch, w)
        hist.append((float(m["loss"]), float(m["delta_norm"])))
    return hist, bridge.to_numpy_tree(y)


@pytest.mark.parametrize("bits", [0, 8])
def test_two_rounds_match_jax(bits):
    cohorts = _cohorts(tsyn, _data(tsyn))
    jhist, jy = _run_jax(bits, cohorts)
    thist, ty = _run_torch(bits, cohorts)
    y0 = dict(jbasic.flatten_params(jax.device_get(
        jpart.partition(jax_init(0), FREEZE)[0])))
    jy, ty = dict(jbasic.flatten_params(jy)), dict(tbasic.flatten_params(ty))
    assert sorted(jy) == sorted(ty)
    moved = max(float(np.abs(jy[k] - y0[k]).max()) for k in jy)
    assert moved > 0
    # round 0 starts from identical parameters and data: the loss is the
    # same float32 forward pass summed in another order
    assert thist[0][0] == pytest.approx(jhist[0][0], rel=1e-5)
    if bits == 0:
        # float32 reassociation only (XLA:CPU vs torch convolutions and
        # matmuls) over 2 rounds x 2 local steps: measured 1 ulp of y
        for (tl, tn), (jl, jn) in zip(thist, jhist):
            assert tl == pytest.approx(jl, rel=1e-5)
            assert tn == pytest.approx(jn, rel=1e-5)
        for k in jy:
            np.testing.assert_allclose(ty[k], jy[k], rtol=1e-5, atol=1e-6)
    else:
        # besides reassociation, a client value on a rounding boundary may
        # land one int8 step (its leaf's max-abs / 127) away; after the
        # weighted mean and SERVER_LR that is below max|y - y0| / 127
        for (tl, tn), (jl, jn) in zip(thist, jhist):
            assert tl == pytest.approx(jl, rel=1e-5)
            assert tn == pytest.approx(jn, rel=1e-3)
        for k in jy:
            np.testing.assert_allclose(ty[k], jy[k], rtol=0,
                                       atol=moved / 127)


@pytest.mark.parametrize("chunk", [1, 2])
def test_rounds_in_client_chunks(monkeypatch, chunk):
    """A cohort past ``VMAP_BYTES`` is vmapped ``chunk`` clients at a time
    (here 3 clients: 1 + 1 + 1, or 2 + 1): the two rounds' losses and
    norms equal the whole-cohort vmap's to rel 1e-6 and y to 1e-6 of
    max|y| (float32 reassociation of batched against per-chunk matrix
    products; measured 0 here), and still match JAX's as
    ``test_two_rounds_match_jax`` holds them."""
    cohorts = _cohorts(tsyn, _data(tsyn))
    whole_hist, whole_y = _run_torch(0, cohorts)
    y, _ = tpart.partition(torch_init(0), FREEZE)
    size = tflat.FlatLayout.of(y).size
    monkeypatch.setattr(tfedpt, "VMAP_BYTES", chunk * 4 * size)
    calls = []
    real = torch.func.vmap
    monkeypatch.setattr(torch.func, "vmap",
                        lambda fn, *a, **k: calls.append(1) or real(fn, *a,
                                                                   **k))
    hist, ty = _run_torch(0, cohorts)
    assert len(calls) == ROUNDS * -(-CLIENTS // chunk)
    for (tl, tn), (wl, wn) in zip(hist, whole_hist):
        assert tl == pytest.approx(wl, rel=1e-6)
        assert tn == pytest.approx(wn, rel=1e-6)
    ty, whole_y = dict(tbasic.flatten_params(ty)), dict(
        tbasic.flatten_params(whole_y))
    for k in ty:
        np.testing.assert_allclose(ty[k], whole_y[k], rtol=0,
                                   atol=1e-6 * np.abs(whole_y[k]).max())
    jhist, _ = _run_jax(0, cohorts)
    for (tl, tn), (jl, jn) in zip(hist, jhist):
        assert tl == pytest.approx(jl, rel=1e-5)
        assert tn == pytest.approx(jn, rel=1e-5)


DP = dict(uplink_bits=8, dp_clip_norm=0.5, dp_noise_multiplier=0.4)


def _run_dp(pkg, cohorts):
    """Two rounds, every parameter trainable, int8 + clip + noise + screen,
    fused tail at any size; returns the metrics and the final y."""
    if pkg == "jax":
        rc = jfedpt.RoundConfig(clients_per_round=CLIENTS, local_steps=STEPS,
                                local_batch=BATCH, client_lr=0.05,
                                server_lr=SERVER_LR, **DP)
        y, frozen = jpart.partition(jax_init(0), ())
        round_fn, sopt = jfedpt.make_round_fn(
            jax_loss, rc, sanitize=jsan.SanitizeConfig(), fused_threshold=0)
        round_fn, key = jax.jit(round_fn), jax.random.key
        weights = jnp.asarray
    else:
        rc = tfedpt.RoundConfig(clients_per_round=CLIENTS, local_steps=STEPS,
                                local_batch=BATCH, client_lr=0.05,
                                server_lr=SERVER_LR, **DP)
        y, frozen = tpart.partition(bridge.from_numpy_tree(
            jax.device_get(jax_init(0)), "cpu"), ())
        round_fn, sopt = tfedpt.make_round_fn(
            torch_loss, rc, device="cpu", sanitize=tsan.SanitizeConfig(),
            fused_threshold=0)
        key, weights = threefry.key, (lambda w: w)
    st = sopt.init(y)
    hist = []
    for r, (batch, w) in enumerate(cohorts):
        y, st, m = round_fn(y, st, frozen, batch, weights(w), key(r))
        hist.append({k: np.asarray(v) for k, v in m.items()})
    return hist, (jax.device_get(y) if pkg == "jax"
                  else bridge.to_numpy_tree(y))


def test_two_dp_rounds_on_the_fused_tail_match_jax():
    cohorts = _cohorts(tsyn, _data(tsyn))
    jhist, jy = _run_dp("jax", cohorts)
    thist, ty = _run_dp("torch", cohorts)
    sigma = 0.4 * 0.5 / CLIENTS
    for tm, jm in zip(thist, jhist):
        assert sorted(tm) == sorted(jm)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        for k in ("quarantine_nonfinite", "quarantine_outlier"):
            assert np.array_equal(tm[k], jm[k]) and not tm[k].any()
        np.testing.assert_allclose(tm["quarantine_norms"],
                                   jm["quarantine_norms"], rtol=1e-4)
        np.testing.assert_allclose(tm["update_norm"], jm["update_norm"],
                                   rtol=1e-4)
        # the norm of the noised tree: the noise dominates it
        assert float(tm["delta_norm"]) == pytest.approx(
            float(jm["delta_norm"]), rel=1e-5)
    # y moves by SERVER_LR x (noise + the clipped mean). The noise agrees
    # to 4 ulps; a client value on a rounding boundary may land one int8
    # step (its leaf's max-abs / 127, below clip_norm / 127 after the
    # clip) away, which the mean over CLIENTS and SERVER_LR shrink; per
    # round, so twice that over two rounds
    jy, ty = dict(jbasic.flatten_params(jy)), dict(jbasic.flatten_params(ty))
    step = 2 * SERVER_LR * 0.5 / 127 / CLIENTS
    for k in jy:
        noise_ulps = 8 * SERVER_LR * np.spacing(np.float32(6 * sigma))
        np.testing.assert_allclose(ty[k], jy[k], rtol=0,
                                   atol=step + noise_ulps)


def test_client_update_gradients_reach_y_only():
    params = torch_init(0)
    y, frozen = tpart.partition(params, FREEZE)
    batch, _ = _cohorts(tsyn, _data(tsyn))[0]
    cb = {k: torch.as_tensor(v[0]) for k, v in batch.items()}
    from repro_torch.optim import optimizers as opt
    update = tfedpt.make_client_update(torch_loss, opt.sgd(0.05), STEPS)
    delta, metrics = update(y, frozen, cb)
    assert sorted(delta) == sorted(y)
    assert torch.isfinite(metrics["client_loss"])
    assert frozen["dense1"]["kernel"].grad is None
    assert all(torch.equal(a, b) for a, b in zip(
        tbasic.tree_leaves(frozen),
        tbasic.tree_leaves(tpart.partition(torch_init(0), FREEZE)[1])))
