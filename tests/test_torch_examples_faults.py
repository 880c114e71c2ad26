"""``examples_torch/async_heterogeneous.py``'s ``--regions`` and
``--chaos`` modes against the reference example at the CI's arguments
(every printed number equal but the losses, held within 5e-3): the
regions run traced as the ``telemetry`` job traces it, the chaos run as
the ``chaos`` job does, each stream carrying the kinds those jobs
require; and the telemetry job's hostile hierarchical run held to
``GOLDEN_telemetry_metrics.json`` by ``repro_torch.obs.compare`` with the
CI's ``--fail-on`` counters.
"""
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)

import _torch_examples as ex
from repro_torch.obs import compare, schema

LOSS_TOL = 5e-3
LOSSES = (r"loss (\d+\.\d+) -> (\d+\.\d+)", r"final loss (\d+\.\d+)")
NAME = "async_heterogeneous"
# the checkpoint's temporary path differs from run to run
CKPT = (r"resuming from \S+",)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_regions_prints_the_references_numbers(tmp_path, monkeypatch):
    """At the CI telemetry job's traced regions invocation (6 updates):
    its stream carries edge_flush and shock records, with causal ids."""
    argv = ["--regions", "--rounds", "6", "--trace", "r.json",
            "--trace-jsonl", "r.jsonl"]
    ref, _ = ex.run_reference(NAME, argv, tmp_path / "ref", monkeypatch)
    twin, res = ex.run_twin(NAME, argv, tmp_path / "twin", monkeypatch)
    ex.compare(ref, twin, fuzzy=LOSSES, tol=LOSS_TOL)
    assert res["hop_table"]["edge_server"]["uploads"] > 0
    d = tmp_path / "twin"
    assert schema.main([str(d / "r.jsonl"), "--perfetto", str(d / "r.json"),
                        "--require", "dispatch", "upload", "flush",
                        "edge_flush", "shock"]) == 0
    assert schema.main([str(d / "r.jsonl"), "--require-ids"]) == 0


def test_chaos_prints_the_references_numbers(tmp_path, monkeypatch):
    argv = ["--chaos", "--rounds", "4", "--trace", "chaos.json",
            "--trace-jsonl", "chaos.jsonl"]
    ref, _ = ex.run_reference(NAME, argv, tmp_path / "ref", monkeypatch)
    twin, res = ex.run_twin(NAME, argv, tmp_path / "twin", monkeypatch)
    ex.compare(ref, twin, fuzzy=LOSSES, tol=LOSS_TOL, masked=CKPT)
    assert res["runs"]["async chaos + quarantine"]["faults"][
        "quarantined"] > 0
    d = tmp_path / "twin"
    assert schema.main([str(d / "chaos.jsonl"), "--perfetto",
                        str(d / "chaos.json"), "--require", "fault",
                        "quarantine", "checkpoint"]) == 0


def test_chaos_regions_passes_the_golden_gate(tmp_path, monkeypatch):
    """The CI telemetry job's hostile hierarchical run: its event stream
    valid with causal ids and the kinds the CI requires, its report
    written, and its metrics snapshot within the golden's gated
    counters."""
    ex.run_twin(NAME, ["--chaos", "--regions", "--rounds", "4",
                       "--trace-jsonl", "combined.jsonl", "--report",
                       "report.md", "--metrics-out", "metrics.json"],
                tmp_path, monkeypatch)
    assert schema.main([str(tmp_path / "combined.jsonl"), "--require-ids",
                        "--require", "dispatch", "upload", "flush",
                        "edge_flush", "fault", "quarantine"]) == 0
    assert (tmp_path / "report.md").read_text().strip()
    argv = [str(ex.ROOT / "GOLDEN_telemetry_metrics.json"),
            str(tmp_path / "metrics.json"), "--changed-only", "-o",
            str(tmp_path / "metrics_diff.md")]
    for counter in ex.FAIL_ON:
        argv += ["--fail-on", counter]
    assert compare.main(argv) == 0
