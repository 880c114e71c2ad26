"""The port's ResNet-18-GN and Stack Overflow NWP transformer against the
JAX package, on the CPU: XLA's "SAME" convolution at any stride, the
global average pool, the paper's trainable counts and flat layouts, the
init's bits, and logits and one gradient on the reference's own
parameters (carried across by ``repro_torch.bridge``).

Tolerances:

* init: zeros and ones exact, normals within 4 ulps (the threefry bits
  are JAX's; torch's and XLA's erfinv round differently,
  ``tests/test_torch_prng.py``);
* one convolution: within 1e-5 (1 + max|y|), float32 sums of at most
  k * k * C_in = 75 products in XLA's and torch's orders;
* ResNet-18 logits within 1e-4 (1 + max|logit|) and its gradient within
  1e-4 of each leaf's max|g| (+1e-6): eighteen convolutions and group
  norms in float32, each reassociating sums of up to 4,608 products;
* SO logits within 1e-4 (1 + max|logit|) and its gradient within 1e-4 of
  each leaf's max|g| (+1e-6): three layers of 96- and 2,048-long dot
  products and the 96-long tied unembedding.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.core import flat as jflat
from repro.models import paper_models as jpm
from repro.nn import basic as jbasic
from repro.nn import conv as jconv
from repro_torch import bridge
from repro_torch.core import flat as tflat
from repro_torch.core import partition as tpart
from repro_torch.launch import train as ttrain
from repro_torch.models import paper_models as tpm
from repro_torch.nn import basic as tbasic
from repro_torch.nn import conv as tconv

ULPS = 4
CONV_TOL = 1e-5
MODEL_TOL = 1e-4


def _ulps(a, b) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def _near(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + float(np.abs(want).max())))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("h", [7, 8, 9, 24, 32])
def test_conv2d_same_matches_xla(h, k, stride):
    rng = np.random.default_rng(h * 100 + k * 10 + stride)
    x = rng.normal(size=(2, h, h + 1, 3)).astype(np.float32)
    p = {"kernel": rng.normal(size=(k, k, 3, 4)).astype(np.float32),
         "bias": rng.normal(size=(4,)).astype(np.float32)}
    want = np.asarray(jconv.conv2d(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, p), stride=stride))
    got = tconv.conv2d(torch.from_numpy(x), bridge.from_numpy_tree(p, "cpu"),
                       stride=stride)
    _near(got, want, CONV_TOL)


def test_same_pads_follow_xla():
    # k 3, s 2, H 32: XLA pads (0, 1); torch's symmetric padding=1 would
    # shift the output by a pixel
    assert tconv.same_pads(32, 3, 2) == (0, 1)
    assert tconv.same_pads(32, 3, 1) == (1, 1)
    assert tconv.same_pads(32, 1, 2) == (0, 0)
    assert tconv.same_pads(7, 2, 1) == (0, 1)
    assert tconv.same_pads(9, 5, 2) == (2, 2)


def test_avgpool_global_matches_jax():
    x = np.random.default_rng(2).normal(size=(3, 5, 7, 6)).astype(np.float32)
    want = np.asarray(jconv.avgpool_global(jnp.asarray(x)))
    got = tconv.avgpool_global(torch.from_numpy(x))
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_resnet():
    return jpm.init_resnet18(0)


@pytest.fixture(scope="module")
def jax_so():
    return jpm.init_so_transformer(0)


def _summary_matches(jparams, tparams, spec):
    want = jpart.summarize(jparams, spec)
    got = tpart.summarize(tparams, spec)
    assert got == want
    return got


# the reference's counts (trainable, total) and the flat layout (size,
# blocks, leaves) of the paths the card runs
RESNET_PT = (2_914_634, 11_172_170, 2_942_976, 2_874, 52)
RESNET_FEDAVG = (11_172_170, 11_172_170, 11_200_512, 10_938, 56)
SO_PT = (1_665_504, 2_261_472, 1_692_672, 1_653, 46)
SO_FEDAVG = (2_261_472, 2_261_472, 2_288_640, 2_235, 52)


def _layout_of(tparams, spec):
    y, _ = tpart.partition(tparams, spec)
    layout = tflat.FlatLayout.of(y)
    return layout.size, layout.num_blocks, len(layout.sizes)


@pytest.mark.parametrize("pct", [None] + sorted(tpm.RESNET_FREEZE_SCHEDULE))
def test_resnet_trainable_counts_match_reference(jax_resnet, pct):
    shapes = {k: torch.zeros(np.shape(v)) for k, v in
              jbasic.flatten_params(jax_resnet)}
    tparams = tbasic.unflatten_params(shapes)
    stages = () if pct is None else tpm.RESNET_FREEZE_SCHEDULE[pct]
    assert tpm.RESNET_FREEZE_SCHEDULE == jpm.RESNET_FREEZE_SCHEDULE
    assert tpm.resnet18_freeze_spec(stages) == jpm.resnet18_freeze_spec(stages)
    row = _summary_matches(jax_resnet, tparams, tpm.resnet18_freeze_spec(stages))
    y, _ = jpart.partition(jax_resnet, jpm.resnet18_freeze_spec(stages))
    jl = jflat.FlatLayout.of(y)
    assert _layout_of(tparams, tpm.resnet18_freeze_spec(stages)) == (
        jl.size, jl.num_blocks, len(jl.sizes))
    if stages == (3,):
        assert (row["trainable_params"], row["total_params"]) + \
            _layout_of(tparams, tpm.resnet18_freeze_spec(stages)) == RESNET_PT
        assert round(row["trainable_pct"], 2) == 26.09
    if stages == ():
        assert (row["trainable_params"], row["total_params"]) + \
            _layout_of(tparams, ()) == RESNET_FEDAVG


@pytest.mark.parametrize("blocks", [(), (2,), (1, 2), (0, 1, 2)])
def test_so_trainable_counts_match_reference(jax_so, blocks):
    shapes = {k: torch.zeros(np.shape(v)) for k, v in
              jbasic.flatten_params(jax_so)}
    tparams = tbasic.unflatten_params(shapes)
    spec = tpm.so_freeze_spec(blocks)
    assert spec == jpm.so_freeze_spec(blocks)
    row = _summary_matches(jax_so, tparams, spec)
    y, _ = jpart.partition(jax_so, spec)
    jl = jflat.FlatLayout.of(y)
    assert _layout_of(tparams, spec) == (jl.size, jl.num_blocks,
                                         len(jl.sizes))
    want = {(0, 1, 2): SO_PT, (): SO_FEDAVG}.get(blocks)
    if want is not None:
        assert (row["trainable_params"], row["total_params"]) + \
            _layout_of(tparams, spec) == want


@pytest.mark.parametrize("model", ["resnet18", "so_transformer"])
def test_init_leaves_match_jax(model, jax_resnet, jax_so):
    jparams = {"resnet18": jax_resnet, "so_transformer": jax_so}[model]
    tparams = {"resnet18": tpm.init_resnet18,
               "so_transformer": tpm.init_so_transformer}[model](
                   0, device="cpu")
    want = dict(jbasic.flatten_params(jparams))
    got = dict(tbasic.flatten_params(tparams))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].dtype == torch.float32, path
        assert _ulps(got[path].numpy(), w) <= ULPS, path


def _image_loss_jax(fwd):
    def loss(params, images, labels):
        lp = jax.nn.log_softmax(fwd(params, images))
        return -jnp.mean(jnp.take_along_axis(lp, labels[:, None], 1))
    return loss


def _check_grads(jgrads, tgrads):
    want = dict(jbasic.flatten_params(jgrads))
    got = dict(tbasic.flatten_params(tgrads))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            got[path].detach().numpy(), w, rtol=0,
            atol=MODEL_TOL * float(np.abs(w).max()) + 1e-6, err_msg=path)


def test_resnet18_logits_and_grad_match_jax(jax_resnet):
    # the widths are fixed; only the image shrinks (8 x 8: three stride-2
    # stages leave 1 x 1)
    rng = np.random.default_rng(3)
    images = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 2).astype(np.int32)
    params = bridge.from_numpy_tree(jax_resnet, "cpu")
    want = np.asarray(jpm.resnet18_forward(jax_resnet, jnp.asarray(images)))
    got = tpm.resnet18_forward(params, torch.from_numpy(images))
    assert got.shape == (2, 10)
    _near(got, want, MODEL_TOL)
    jg = jax.grad(_image_loss_jax(jpm.resnet18_forward))(
        jax_resnet, jnp.asarray(images), jnp.asarray(labels))
    loss = ttrain.image_loss(tpm.resnet18_forward)
    tg = torch.func.grad(lambda p: loss(p, {
        "images": torch.from_numpy(images),
        "labels": torch.from_numpy(labels)})[0])(params)
    _check_grads(jg, tg)


def test_so_transformer_logits_and_grad_match_jax(jax_so):
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 10004, (2, 20)).astype(np.int32)
    params = bridge.from_numpy_tree(jax_so, "cpu")
    want = np.asarray(jpm.so_transformer_forward(jax_so, jnp.asarray(tokens)))
    got = tpm.so_transformer_forward(params, torch.from_numpy(tokens))
    assert got.shape == (2, 20, 10004) and got.dtype == torch.float32
    _near(got, want, MODEL_TOL)
    from repro.models import decoder_lm as jdlm

    def jloss(p, t):
        logits = jpm.so_transformer_forward(p, t)
        return jdlm.lm_loss(logits[:, :-1], t[:, 1:])
    jg = jax.grad(jloss)(jax_so, jnp.asarray(tokens))
    loss = ttrain.token_loss(tpm.so_transformer_forward)
    tg = torch.func.grad(lambda p: loss(
        p, {"tokens": torch.from_numpy(tokens)})[0])(params)
    _check_grads(jg, tg)
