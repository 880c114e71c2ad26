"""Shared by the ``tests/test_torch_examples*.py`` files: runs a reference
example (``examples/``, JAX on the CPU) and its ``examples_torch/`` twin
(``--device cpu``) in this process and compares what they print.

Each runs from a directory of its own under the test's ``tmp_path``, so
the file arguments (``--trace trace.json``, ...) are the same relative
names in both and print the same. The reference runs with ``runpy`` and
a patched ``sys.argv``, as ``python examples/<name>.py ...`` would; the
twin through its ``main(argv)``.

:func:`compare` holds the two outputs line by line: every number equal as
printed (counts, bytes, virtual seconds, census, tier rows, cache
elements), except the losses and accuracies that the example's ``fuzzy``
patterns capture, which are held within an absolute tolerance, and the
text that its ``masked`` patterns cover (wall times, temporary paths),
which is not compared.
"""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "examples"
TWINS = ROOT / "examples_torch"
NAMES = ("quickstart", "async_heterogeneous", "adaptive_tiers",
         "dp_federated_lm", "federated_llm_finetune", "serve_longcontext")

# the golden gate of the CI's telemetry job (.github/workflows/ci.yml)
FAIL_ON = ("counter.dispatches", "counter.uploads", "counter.dropouts",
           "counter.crashes", "counter.truncated", "counter.duplicates",
           "counter.corrupted", "counter.quarantined")


def load_twin(name: str):
    """The twin ``examples_torch/<name>.py`` as a module (its ``main`` not
    run)."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", TWINS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_twin(name: str, argv, cwd: Path, monkeypatch):
    """(stdout, main's result) of the twin run with ``argv`` + ``--device
    cpu`` from ``cwd``."""
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = load_twin(name).main(list(argv) + ["--device", "cpu"])
    return out.getvalue(), res


def run_reference(name: str, argv, cwd: Path, monkeypatch):
    """(stdout, the script's globals) of ``examples/<name>.py`` run with
    ``argv`` from ``cwd``."""
    cwd.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(cwd)
    path = str(REFERENCE / f"{name}.py")
    monkeypatch.setattr(sys, "argv", [path] + list(argv))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scope = runpy.run_path(path, run_name="__main__")
    return out.getvalue(), scope


def _lines(text: str):
    return [ln.rstrip() for ln in text.splitlines() if ln.strip()]


def compare(ref: str, twin: str, fuzzy=(), tol: float = 0.0,
            masked=()) -> float:
    """Holds the twin's printed lines to the reference's (see the module
    docstring); returns the largest difference of a fuzzy number."""
    a_lines, b_lines = _lines(ref), _lines(twin)
    assert len(a_lines) == len(b_lines), (a_lines, b_lines)
    worst = 0.0
    for a, b in zip(a_lines, b_lines):
        for pat in masked:
            a, b = re.sub(pat, "<masked>", a), re.sub(pat, "<masked>", b)
        for pat in fuzzy:
            ma, mb = list(re.finditer(pat, a)), list(re.finditer(pat, b))
            assert len(ma) == len(mb), (a, b)
            for x, y in zip(ma, mb):
                for g in range(1, (x.lastindex or 0) + 1):
                    gap = abs(float(x.group(g)) - float(y.group(g)))
                    assert gap <= tol, (pat, a, b, gap, tol)
                    worst = max(worst, gap)
            a, b = re.sub(pat, "<fuzzy>", a), re.sub(pat, "<fuzzy>", b)
        assert a == b
    return worst


def reference_flags(name: str) -> dict:
    """The reference example's ``add_argument`` calls: flag -> its keyword
    arguments that ``ast.literal_eval`` can read (default, type name,
    action), from its source."""
    import ast
    tree = ast.parse((REFERENCE / f"{name}.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {}
            for k in node.keywords:
                if k.arg in ("default", "action"):
                    kw[k.arg] = ast.literal_eval(k.value)
                elif k.arg == "type":
                    kw["type"] = k.value.id
            flags[node.args[0].value] = kw
    return flags
