"""``examples_torch/async_heterogeneous.py`` against the reference
example at the CI's arguments: the default mode traced as the
``telemetry`` job runs it, and ``--tiers`` as the ``examples`` job does;
every printed number equal but the losses, which are held within 5e-3
(measured: equal to the printed 3 decimals); the traced run's event
stream valid under the port's schema validator with the kinds and
causal ids the CI requires.
"""
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)

import _torch_examples as ex
from repro_torch.obs import schema

LOSS_TOL = 5e-3
LOSSES = (r"loss (\d+\.\d+) -> (\d+\.\d+)", r"final loss (\d+\.\d+)")
NAME = "async_heterogeneous"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parity(argv, tmp_path, monkeypatch):
    ref, _ = ex.run_reference(NAME, argv, tmp_path / "ref", monkeypatch)
    twin, res = ex.run_twin(NAME, argv, tmp_path / "twin", monkeypatch)
    ex.compare(ref, twin, fuzzy=LOSSES, tol=LOSS_TOL)
    return res


def test_default_mode_prints_the_references_numbers(tmp_path, monkeypatch):
    """At the CI telemetry job's traced invocation (3 updates)."""
    res = _parity(["--rounds", "3", "--trace", "trace.json", "--trace-jsonl",
                   "trace.jsonl"], tmp_path, monkeypatch)
    assert list(res["runs"]) == ["sync + deadline", "async (FedBuff)"]
    d = tmp_path / "twin"
    assert schema.main([str(d / "trace.jsonl"), "--perfetto",
                        str(d / "trace.json"), "--require", "dispatch",
                        "upload", "flush"]) == 0
    assert schema.main([str(d / "trace.jsonl"), "--require-ids"]) == 0


def test_tiers_prints_the_references_numbers(tmp_path, monkeypatch):
    res = _parity(["--tiers", "--rounds", "4"], tmp_path, monkeypatch)
    runs = res["runs"]
    assert runs["async tiered"]["up_bytes"] < runs["async all-full"][
        "up_bytes"]
    assert set(runs["async tiered"]["tier_stats"]) == {"full", "mid", "lite"}
