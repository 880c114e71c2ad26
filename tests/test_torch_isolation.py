"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and its entry points
refuse to drop to the CPU on their own when there is no CUDA card.
"""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.core.fedpt" in mods and "repro_torch.kernels.ops" in mods
    assert {"repro_torch.checkpoint.grid_state", "repro_torch.sim.topology",
            "repro_torch.obs.profiling", "repro_torch.obs.analyze",
            "repro_torch.configs.mistral_nemo_12b", "repro_torch.nn.attention",
            "repro_torch.models.decoder_lm", "repro_torch.launch.serve",
            "repro_torch.launch.specs", "repro_torch.kernels.swa_attention",
            "repro_torch.kernels.seed_reconstruct"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))


def _twin(path: Path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"twin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_twins_import_neither_jax_nor_repro():
    assert [p.stem for p in EXAMPLES] == sorted(
        p.stem for p in (ROOT / "examples").glob("*.py"))
    for path in EXAMPLES:
        bad = set(_imported_roots(path)) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_raise_without_cuda():
    _no_cuda()
    from repro_torch import bridge
    from repro_torch.core import fedpt, reconstruct, sanitize
    from repro_torch.kernels import agg_tail
    from repro_torch.models import paper_models as pm
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        pm.init_emnist_cnn(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        reconstruct.init_partitioned(pm.init_emnist_cnn, 0, pm.EMNIST_FREEZE)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpt.make_round_fn(lambda p, b: 0.0, fedpt.RoundConfig(2, 1, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.from_numpy_tree({"a": np.zeros(3, np.float32)})
    from repro_torch.data import synthetic as syn
    from repro_torch.fl import runtime
    from repro_torch.sim import grid
    ds = syn.make_federated_images(4, 8, (8, 8, 1), 4, seed=0)
    rc = fedpt.RoundConfig(2, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        grid.run_grid(lambda s: {}, lambda p, b: 0.0, ds, rc, 1,
                      grid=grid.GridConfig(mode="async"))
    with pytest.raises(RuntimeError, match="CUDA"):
        runtime.run_federated(lambda s: {}, lambda p, b: 0.0, ds, rc, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpt.make_lane_step(lambda p, b: 0.0, rc, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fedpt.make_round_fn(
            lambda p, b: 0.0,
            fedpt.RoundConfig(2, 1, 4, uplink_bits=8, dp_clip_norm=0.5,
                              dp_noise_multiplier=0.4),
            sanitize=sanitize.SanitizeConfig(), fused_threshold=0)
    # the fused tail's wrappers, asked for anything but a CPU tensor, go to
    # the kernels: they refuse a tensor that is not on the card
    meta = torch.empty((2, 1024), device="meta")
    for call in (lambda: agg_tail.block_stats(meta),
                 lambda: agg_tail.pack(meta, torch.empty((2, 1),
                                                         device="meta")),
                 lambda: agg_tail.apply_coeff(meta.to(torch.int8)[:, None],
                                              torch.empty((2, 1),
                                                          device="meta"))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    # the serving path: the decoder LM, its steps and its kernels
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, specs, train
    from repro_torch.launch.train import reduced_config
    from repro_torch.models import decoder_lm as dlm
    cfg = reduced_config(get_config("mistral-nemo-12b"))
    for call in (lambda: dlm.init_model(cfg, 0),
                 lambda: dlm.init_cache(cfg, 1, 8),
                 lambda: specs.make_prefill_step(cfg),
                 lambda: specs.make_decode_step(cfg),
                 lambda: serve.generate({}, cfg, np.zeros((1, 2), np.int32), 1),
                 lambda: serve.main(["--arch", "mistral-nemo-12b"]),
                 lambda: train.run_paper_task("stackoverflow", 1, False),
                 lambda: train.main(["--task", "cifar", "--rounds", "1"]),
                 lambda: ops.seed_reconstruct(0, 0, (4, 4), 1.0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    qkv = torch.empty((1, 2, 64, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.swa_attention(qkv, qkv, qkv)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("path", EXAMPLES, ids=[p.stem for p in EXAMPLES])
def test_example_twins_raise_without_cuda(path):
    """Each twin runs on the card by default and raises without one."""
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        _twin(path).main([])


def test_round_refuses_parameters_on_another_device():
    from repro_torch.core import fedpt
    round_fn, _ = fedpt.make_round_fn(lambda p, b: 0.0,
                                      fedpt.RoundConfig(2, 1, 4),
                                      device="cpu")
    y = {"w": torch.zeros(3, device="meta")}
    with pytest.raises(ValueError, match="parameters on meta"):
        round_fn(y, (), {}, {}, np.ones(2, np.float32))


def test_chip_smoke_fails_without_cuda(tmp_path):
    _no_cuda()
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone / "chip_smoke.py")
    for cwd in (ROOT, lone):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


# modules the port keeps as copies of the reference's (stdlib / numpy
# host code): the same code, with ``repro.`` read as ``repro_torch.``;
# docstrings may be reworded where they narrate the reference's history
COPIES = ("obs/schema", "obs/export", "obs/metrics", "obs/trace",
          "obs/analyze", "obs/report", "obs/compare",
          "sim/dynamics", "sim/faults", "sim/devices", "sim/selection",
          "sim/scheduler", "core/comm", "data/synthetic", "fl/tuning")


def _code(text: str) -> str:
    """The module's AST with every docstring blanked (comments are not in
    the AST)."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant) and isinstance(
                        first.value.value, str):
                first.value.value = ""
    return ast.dump(tree)


@pytest.mark.parametrize("name", COPIES)
def test_host_copies_match_reference(name):
    ref = (SRC / "repro" / f"{name}.py").read_text().replace(
        "repro.", "repro_torch.")
    port = (SRC / "repro_torch" / f"{name}.py").read_text()
    assert _code(port) == _code(ref)
    changed = [(a, b) for a, b in zip(ref.splitlines(), port.splitlines())
               if a != b]
    assert len(ref.splitlines()) == len(port.splitlines())
    assert len(changed) <= 5, changed


# tables the port keeps as literal copies of the reference's
RULE_TABLES = [("launch/sharding", n) for n in
               ("_RULES", "_RULES_2D_EXPERTS", "_RULES_FFN_EXPERTS",
                "_RULES_2D_EXPERTS_SWAPPED")] + [("launch/specs", "LONG_OK")]


def _assigned_literal(path: Path, name: str):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{name} is not assigned in {path}")


@pytest.mark.parametrize("module,name", RULE_TABLES)
def test_rule_tables_match_reference(module, name):
    """The sharding rule tables (and the long-context set) are the
    reference's, entry for entry and in order."""
    assert _assigned_literal(SRC / "repro_torch" / f"{module}.py", name) \
        == _assigned_literal(SRC / "repro" / f"{module}.py", name)
