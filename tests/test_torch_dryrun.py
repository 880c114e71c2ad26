"""The port's dry run (``repro_torch.launch.dryrun``) in a fake world, on
the CPU: the reference's two pairs of ``tests/test_dryrun.py``
(``stablelm-1.6b x decode_32k``, ``mixtral-8x7b x train_4k``) at full
width and depth on a fake (2, 4) mesh, in a subprocess (a fake world is
process-wide) under its own time limit; a skipped pair; and the command
line on the production (16, 16) mesh.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("stablelm-1.6b", "decode_32k"), ("mixtral-8x7b", "train_4k")]

SCRIPT = r"""
import json, sys
from repro_torch.configs import load_all
from repro_torch.launch import dryrun
load_all()
mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
out = [dryrun.run_one(a, s, mesh=mesh, verbose=False)
       for a, s in %r + [("qwen2.5-3b", "long_500k")]]
print(json.dumps(out))
""" % (PAIRS,)


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.fixture(scope="module")
def results():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], env=_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(PAIRS)))
def test_dryrun_pair_on_fake_mesh(results, i):
    r = results[i]
    assert (r["arch"], r["shape"]) == PAIRS[i]
    assert r["status"] == "ok", r
    assert r["mesh"] == [2, 4]
    assert r["cost"]["flops"] > 0
    mem = r["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert mem["output_bytes"] > 0
    # the parameters' model shards are gathered: at least one all-gather
    assert r["collectives"]["all-gather"]["count"] > 0
    assert r["collectives"]["all-gather"]["bytes"] > 0
    if PAIRS[i][1] == "train_4k":
        assert r["clients"] == 2          # one client a data rank
    # the result says which step it traced: the port's data-parallel one
    assert r["layout"] == dryrun.LAYOUT


def test_dryrun_skips_by_skip_reason(results):
    r = results[-1]
    assert r["status"] == "skip"
    assert "full-attention" in r["reason"]


def test_dryrun_command_line_on_production_mesh(tmp_path):
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "stablelm-1.6b", "--shape", "decode_32k", "--out", str(out)],
        env=_env(), capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (r,) = json.loads(out.read_text())
    assert r["status"] == "ok" and r["mesh"] == [16, 16]
    assert "1 jobs: 1 ok, 0 skip, 0 error" in proc.stdout
