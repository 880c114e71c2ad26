"""``.github/workflows/torch.yml``, the port's CI: its three jobs, every
``examples_torch/`` script it names exists and its parser takes every
flag the workflow passes, each twin runs on the CPU there, and every
invocation that ``ci.yml`` makes of a reference example has its twin's
(the same arguments plus ``--device cpu``).
"""
import shlex
from pathlib import Path

import pytest

yaml = pytest.importorskip("yaml")

import _torch_examples as ex  # noqa: E402

WORKFLOWS = ex.ROOT / ".github" / "workflows"


def _invocations(path: Path, folder: str):
    """(script name, argv) of every ``python <folder>/<name>.py ...`` in
    the workflow's ``run`` steps, in order."""
    doc = yaml.safe_load(path.read_text())
    found = []
    for job in doc["jobs"].values():
        for step in job.get("steps", []):
            for line in str(step.get("run", "")).splitlines():
                words = shlex.split(line)
                for i, w in enumerate(words):
                    if w.startswith(f"{folder}/") and w.endswith(".py"):
                        found.append((Path(w).stem, words[i + 1:]))
    return found


TORCH = _invocations(WORKFLOWS / "torch.yml", "examples_torch")


def test_the_workflow_has_its_three_jobs():
    doc = yaml.safe_load((WORKFLOWS / "torch.yml").read_text())
    assert set(doc["jobs"]) == {"torch-tests", "torch-examples",
                                "torch-telemetry"}
    runs = [s.get("run", "") for s in doc["jobs"]["torch-tests"]["steps"]]
    assert any("pytest" in r and "tests/test_torch_*.py" in r for r in runs)


@pytest.mark.parametrize("name,argv", TORCH,
                         ids=[" ".join([n] + a) for n, a in TORCH])
def test_each_invocation_names_a_twin_and_flags_it_takes(name, argv):
    assert (ex.TWINS / f"{name}.py").is_file()
    args = ex.load_twin(name).parser().parse_args(argv)
    assert args.device == "cpu"


def test_every_twin_runs_and_every_reference_invocation_has_its_twin():
    assert {n for n, _ in TORCH} == set(ex.NAMES)
    ours = {(n, tuple(a)) for n, a in TORCH}
    for name, argv in _invocations(WORKFLOWS / "ci.yml", "examples"):
        assert (name, tuple(argv) + ("--device", "cpu")) in ours, (name, argv)
