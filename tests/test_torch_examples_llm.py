"""``examples_torch/adaptive_tiers.py`` at the CI's 8 updates,
``federated_llm_finetune.py`` on reduced Mixtral at its 8 rounds and
``serve_longcontext.py`` against the reference examples: every printed
number equal but the losses (held within 5e-3; measured: 2e-3 after 8
adaptive-tier updates, equal to the printed 3 decimals in the
fine-tune) and the serving wall times (not compared); the serving
prompt, drawn from ``repro_torch.nn.threefry``, equal to the
reference's ``jax.random`` draw.
"""
import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)

import _torch_examples as ex

LOSS_TOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parity(name, argv, tmp_path, monkeypatch, **kw):
    ref, scope = ex.run_reference(name, argv, tmp_path / "ref", monkeypatch)
    twin, res = ex.run_twin(name, argv, tmp_path / "twin", monkeypatch)
    ex.compare(ref, twin, **kw)
    return scope, res


def test_adaptive_tiers_prints_the_references_numbers(tmp_path,
                                                      monkeypatch):
    _, res = _parity("adaptive_tiers", ["--rounds", "8"], tmp_path,
                     monkeypatch, fuzzy=(r"loss (\d+\.\d+) -> (\d+\.\d+)",),
                     tol=LOSS_TOL)
    assert res["refits"] >= 1 and len(res["losses"]) == 8


def test_federated_llm_finetune_prints_the_references_numbers(
        tmp_path, monkeypatch):
    _, res = _parity("federated_llm_finetune",
                     ["--arch", "mixtral-8x7b", "--rounds", "8"], tmp_path,
                     monkeypatch, fuzzy=(r"loss=(\d+\.\d+)",
                                         r"loss (\d+\.\d+) -> (\d+\.\d+)"),
                     tol=LOSS_TOL)
    assert res["losses"][-1] < res["losses"][0]


def test_serve_longcontext_prints_the_references_numbers(tmp_path,
                                                         monkeypatch):
    scope, res = _parity("serve_longcontext", [], tmp_path, monkeypatch,
                         masked=(r"in \d+\.\d+s",))
    # the reference's globals hold its last architecture's prompt
    last = res[ex.load_twin("serve_longcontext").ARCHS[-1]]
    np.testing.assert_array_equal(last["prompt"], np.asarray(scope["prompt"]))
    assert last["tokens"].shape == np.asarray(scope["seqs"]).shape
