"""The port's dry run (``repro_torch.launch.dryrun``) in a fake world, on
the CPU: the reference's two pairs of ``tests/test_dryrun.py``
(``stablelm-1.6b x decode_32k``, ``mixtral-8x7b x train_4k``), a dense
prefill (``stablelm-1.6b x prefill_32k``) at full width and depth,
``deepseek-v2-236b`` x ``train_4k`` and x ``prefill_32k`` at full width,
1 of its 60 layers, ``jamba-v0.1-52b`` x ``train_4k`` at full width, 2
layers at an attention period of 2, ``paligemma-3b x train_4k`` at full
width, 1 of its 18 layers (its 256 patch embeddings a sequence), and
``whisper-large-v3 x prefill_32k`` at full width, 1 + 1 of its 32 + 32
layers (1,500 frames a row; the cuts keep the subprocess well inside its
limit), on a fake (2, 4) mesh, in a subprocess (a fake world is
process-wide) under its own time limit; a skipped pair; and the command
line on the production (16, 16) mesh.

The train step and the prefill are tensor-parallel on "model" for every
family (layout ``specs.TP_LAYOUT``): each rank's argument bytes are
exactly the rule sum (each leaf's bytes over the sizes of the axes its
placements shard), and no parameter is gathered: every leaf that the
decoder LM's loss and forward receive (``tests/_torch_seen.FrozenSeen``) holds
the rules' piece's elements, the frozen tree's and y's alike. PaliGemma's
``mm_proj`` matches no rule and is whole on every rank; Whisper's vocab
of 51,866 divides the 4-wide axis no more than the reference's 16, so
its embedding and unembedding are whole too. DeepSeek-V2's experts sit
on "data" and "model" (the ``2d`` mode), so its step exchanges each MoE
layer's buffer over "data": its collectives include all-to-alls; so do
Jamba's (the sums, and each Mamba layer's ``in_proj`` output moved from a
rank's column block to its channels). DeepSeek-V2's prefill, whose rows
are split over "data", holds only each rank's experts' slots of the MoE
buffer: no near-peak tensor has the global slot layout's rows, and its
peak is below the parent tree's, which built the whole buffer on every
data rank. The decode keeps the gathered
layout (``specs.GATHERED_LAYOUT``): its parameters' "model" shards are
all-gathered.
"""
import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import dryrun, specs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [("stablelm-1.6b", "decode_32k"), ("mixtral-8x7b", "train_4k"),
         ("stablelm-1.6b", "prefill_32k"), ("deepseek-v2-236b", "train_4k"),
         ("deepseek-v2-236b", "prefill_32k"), ("jamba-v0.1-52b", "train_4k"),
         ("paligemma-3b", "train_4k"), ("whisper-large-v3", "prefill_32k")]
TP_KINDS = ("train_4k", "prefill_32k")
# pairs traced at a cut config: overrides. Jamba's layer program has a
# period of 8 (7 Mamba layers, whose scans trace a position at a time:
# one period's train step traced for over 7 minutes here), so its
# attention period is cut to 2: Mamba with the dense FFN, then attention
# with the MoE, each of its block kinds once
CUT = {("deepseek-v2-236b", "train_4k"): {"num_layers": 1},
       ("deepseek-v2-236b", "prefill_32k"): {"num_layers": 1},
       ("jamba-v0.1-52b", "train_4k"): {"num_layers": 2, "attn_period": 2},
       ("paligemma-3b", "train_4k"): {"num_layers": 1},
       ("whisper-large-v3", "prefill_32k"): {"num_layers": 1,
                                             "encoder_layers": 1}}

# each pair's result also carries ``seen``: the element counts of every
# parameter leaf that the decoder LM's loss and forward received
SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config, load_all
from repro_torch.launch import dryrun, specs
from _torch_seen import FrozenSeen
from repro_torch.nn import basic
load_all()
mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
cut = %r
out = []
for a, s in %r + [("qwen2.5-3b", "long_500k")]:
    cfg = get_config(a).with_(**cut[a, s]) if (a, s) in cut else None
    paths = [p for t in specs.param_structs(cfg or get_config(a))
             for p, _ in basic.flatten_params(t)]
    with FrozenSeen(paths) as seen:
        r = dryrun.run_one(a, s, mesh=mesh, verbose=False, cfg_override=cfg)
    r["seen"] = {p: sorted(n) for p, n in seen.seen.items()}
    out.append(r)
print(json.dumps(out))
""" % (CUT, PAIRS)


def _env():
    # tests/ for the test helper _torch_seen
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        (os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"))),
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
    # what holds the peak: the storages live within 1% of it, grouped
    assert mem["peak_bytes"] >= mem["near_peak_bytes"] \
        >= mem["peak_bytes"] / dryrun.LiveBytes.PEAK_STEP
    top = mem["near_peak_top"]
    assert top and sum(g[1] for g in top) <= mem["near_peak_bytes"]
    assert [g[1] for g in top] == sorted((g[1] for g in top), reverse=True)
    assert mem["output_bytes"] > 0
    # every step runs collectives: the decode's parameters' model shards
    # are gathered; the tensor-parallel steps' reductions and the flat
    # plane's steps are all-gathers of pieces
    assert r["collectives"]["all-gather"]["count"] > 0
    assert r["collectives"]["all-gather"]["bytes"] > 0
    if PAIRS[i][1] == "train_4k":
        assert r["clients"] == 2          # one client a data rank
    # the result says which layout its step traced, and a tensor-parallel
    # step's per-rank arguments are the rule sum exactly
    tp = PAIRS[i][1] in TP_KINDS
    assert r["layout"] == (specs.TP_LAYOUT if tp
                           else specs.GATHERED_LAYOUT)
    assert mem["argument_bytes"] == mem["rule_argument_bytes"]
    if PAIRS[i][0] in ("deepseek-v2-236b", "jamba-v0.1-52b"):
        # the experts' exchange over "data", Mamba's channel move (and the
        # tp_reduce sums)
        assert r["collectives"]["all-to-all"]["count"] > 0


TP_PAIRS = [i for i, (_, shape) in enumerate(PAIRS) if shape in TP_KINDS]


@pytest.mark.parametrize("i", TP_PAIRS)
def test_tp_steps_receive_only_the_rules_pieces(results, i):
    """No parameter is gathered in a tensor-parallel step: every leaf of
    y and of the frozen tree reaches the decoder LM's loss (the train
    step, each client's y under ``vmap``) or forward (the prefill) as the
    rules' piece, its whole elements over the sizes of the axes its
    placements shard, and no other size; a leaf no rule splits (the VLM's
    ``mm_proj``, Whisper's vocab) whole."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tshard
    from repro_torch.nn import basic
    arch, shape = PAIRS[i]
    cfg = get_config(arch).with_(**CUT.get((arch, shape), {}))
    mesh = tmesh.AbstractMesh((2, 4), ("data", "model"))
    seen = results[i]["seen"]
    want, split = {}, 0
    for tree in specs.param_structs(cfg):
        placed = dict(basic.flatten_params(
            tshard.param_shardings(tree, cfg, mesh)))
        for path, leaf in basic.flatten_params(tree):
            parts = math.prod(n for n, p in zip((2, 4), placed[path])
                              if p.is_shard())
            want[path] = [leaf.numel() // parts]
            split += parts > 1
    assert split and seen == want
    if arch == "paligemma-3b":
        assert seen["mm_proj/kernel"] == [1152 * cfg.d_model]
    if arch == "whisper-large-v3":
        assert seen["embed/embedding"] == [cfg.vocab_size * cfg.d_model]
        assert seen["layers/slot0/cross_attn/wq/kernel"] == [
            cfg.d_model * cfg.d_model // 4]


# the parent tree's traced peak of deepseek-v2-236b x prefill_32k at 1
# layer on the fake (2, 4) mesh, when every data rank built the whole
# (160, 49,152, 5,120) bf16 dispatch buffer (80.5 GB), summed it over
# "data" and gathered the experts' outputs back at that size (traced on
# the CPU, the same host and script)
PARENT_DS_PREFILL_PEAK = 306_210_084_104


def test_deepseek_prefill_holds_only_its_experts_slots(results):
    """The 2-D experts' prefill on a data split: no near-peak tensor has
    the global slot layout's 160 x cap rows (a rank fills only its 80
    experts' slots), and the traced peak is below the parent's."""
    from repro_torch.configs import get_config
    from repro_torch.nn import moe
    i = PAIRS.index(("deepseek-v2-236b", "prefill_32k"))
    r = results[i]
    cfg = get_config("deepseek-v2-236b")
    kind = specs.SHAPES["prefill_32k"]
    cap = moe.capacity(kind["global_batch"] * kind["seq"], cfg)
    rows = cfg.num_experts * cap
    labels = [g[0] for g in r["memory"]["near_peak_top"]]
    assert not [lab for lab in labels
                if f"[{rows}," in lab or f"[{cfg.num_experts}, {cap}," in lab]
    assert r["memory"]["peak_bytes"] < PARENT_DS_PREFILL_PEAK


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
