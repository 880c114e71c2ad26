"""Tensor parallelism on the mesh's "model" axis (``launch/specs``'s
tensor-parallel train step and prefill) on ``gloo`` ranks on the CPU, on
the 2 x 2 (``debug``) and 2 x 2 x 2 (``debug-pod``) presets.

Each rank trains and prefills on its pieces of ``y`` and of the frozen
tree, placed by the reference's rules (``launch/sharding.param_shardings``):
column-parallel q / k / v and FFN-in projections, row-parallel ``wo``s,
the vocab split on "model" (a masked embedding lookup, the unembedding's
columns, the vocab-parallel cross-entropy), and the experts split by
expert (the ``model`` mode) or by FFN column (``ffn``). The cases: a
reduced StableLM-2 (dense), a reduced Mixtral in both expert modes, a
reduced Qwen2.5 with one kv head, which the 2-wide "model" axis splits
in half (each rank gathers the kv projection and takes the head its q
heads use), the StableLM again in bf16 compute, and the Mixtral in both
expert modes at a capacity factor of 0.5, where experts overflow and an
expert's entries span data ranks. The prefill's rows are split over the
data axes (in ``torch.chunk``'s pieces: the second overflow case's 3
rows fall 2, 1 on the 2 x 2 world and 1, 1, 1, 0 on the 2 x 2 x 2 one, a
data rank with no rows), and an MoE counts its capacity and slot ranks
over the whole batch, as the reference's forward does; so the prefill is
held to the forward of the whole batch. The first overflow case also
runs the meshed decode step (``specs.make_mesh_decode_step``) on a warm
cache of 4 rows, held to the unmeshed ``decode_step`` and to the
reference's.

Bounds (float32 compute). Against the port's unsharded round: the
update ``y_new - y`` within 1e-5 of its norm (``tests/test_torch_mesh.py``'s
bound for the meshed round: the ranks' partial products are summed in another order
than one GEMM sums them; measured ~2e-6) and the loss within rel 1e-5;
the prefill's logits within 1e-5 of the largest |logit|. Against the
reference's JAX round and forward on the same numpy inputs: the update
within 1e-4 of its norm, the loss and the logits within the zoo's rtol /
atol 1e-4 (``tests/_torch_zoo_cases.py``: another framework's dot
products). In bf16 compute, against the port's unsharded bf16 round and
forward, no farther than that unsharded bf16 run is from its float32
twin (by update norm, and by the largest |logit|): each rank rounds its
row-parallel partial product to bf16 before the ranks' float32 sum is
rounded again, where one GEMM rounds the whole sum once, so the TP run
is another bf16 rounding of the same function (measured on the dense
StableLM; a bf16 MoE router can flip a near-tie between two such
roundings, which moves a token's whole expert output).

Also: two runs of the step from the same inputs are bit for bit; every
rank returns the same gathered y and logits; each rank's frozen pieces
hold the whole leaf's elements over the shards, and those pieces are
what the model's loss and forward receive inside the steps (the frozen
tree is never gathered); the new y keeps the rules' placements; the prefill's logits
leave the step split on vocab.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro  # noqa: F401  (sets JAX's partitionable threefry)
import jax
import jax.numpy as jnp

import repro.core.partition as jpart
from repro.configs.base import get_config as jget
from repro.core import fedpt as jfedpt
from repro.launch.train import reduced_config as jreduced
from repro.models import decoder_lm as jdlm
from repro_torch import bridge
from repro_torch.configs import base as tbase
from repro_torch.core import fedpt as tfedpt
from repro_torch.core import partition as tpart
from repro_torch.launch import specs
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

import _torch_mesh_worker as worker

UPDATE_REL = 1e-5            # TP against the port's unsharded round
JAX_UPDATE_REL = 1e-4        # TP against the reference's round
LOGIT_REL = 1e-5             # TP prefill against the port's forward
JAX_TOL = 1e-4               # the zoo's rtol / atol against JAX

# case -> (arch, overrides of its reduced config)
CASES = {
    "stablelm": ("stablelm-1.6b", {}),
    "mixtral": ("mixtral-8x7b", {}),
    "mixtral_ffn": ("mixtral-8x7b", {"expert_shard": "ffn"}),
    "qwen_split_kv": ("qwen2.5-3b", {"num_heads": 4, "num_kv_heads": 1}),
    "stablelm_bf16": ("stablelm-1.6b", {"compute_dtype": "bfloat16"}),
    "mixtral_overflow": ("mixtral-8x7b", {"moe_capacity_factor": 0.5}),
    "mixtral_ffn_overflow": ("mixtral-8x7b", {"expert_shard": "ffn",
                                              "moe_capacity_factor": 0.5}),
}
OVERFLOW = [c for c in CASES if c.endswith("_overflow")]
PREFILL_ROWS = {"mixtral_ffn_overflow": 3}       # else 4
DECODE = {"mixtral_overflow": (4, 4)}            # (rows, tokens a row)
# the prefill's rows are split over the data axes: 2 of them on 2 x 2, 4
# on 2 x 2 x 2; the data axes' sizes in mesh order
DATA_RANKS = {"debug": 2, "debug-pod": 4}
DATA_AXES = {2: (2,), 4: (2, 2)}
R = worker.TP_ROUND
RC = dict(clients_per_round=0, local_steps=R["tau"], local_batch=0,
          client_opt="sgd", client_lr=0.02, server_opt="sgdm",
          server_lr=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _twin(case):
    return case.replace("_bf16", "")


def _jcfg(case):
    arch, over = CASES[case]
    return jreduced(jget(arch), max_layers=2, d_model=128,
                    vocab=300).with_(**over)


def _tcfg(case):
    return tbase.ModelConfig(**dataclasses.asdict(_jcfg(case)))


@pytest.fixture(scope="module")
def inputs():
    """Each case's parameters (the reference's init, as numpy), its
    round's batch and its prefill's tokens."""
    out = {}
    for case in CASES:
        jcfg = _jcfg(case)
        params = jax.tree_util.tree_map(np.asarray, jdlm.init_model(jcfg, 0))
        # a bf16 case takes its float32 twin's inputs
        rng = np.random.default_rng(list(CASES).index(_twin(case)))
        tok = rng.integers(0, jcfg.vocab_size, (R["clients"], R["tau"],
                                                 R["batch"], R["seq"]),
                           dtype=np.int32)
        out[case] = {"arch": CASES[case][0], "cfg": _tcfg(case),
                     "params": params,
                     "batch": {"tokens": tok, "labels": tok},
                     "prefill": rng.integers(
                         0, jcfg.vocab_size, (PREFILL_ROWS.get(case, 4),
                                              R["seq"]), dtype=np.int32)}
        if case in DECODE:
            out[case]["decode"] = rng.integers(0, jcfg.vocab_size,
                                               DECODE[case], dtype=np.int32)
    return out


@pytest.fixture(scope="module", params=list(DATA_RANKS))
def world(request, inputs, tmp_path_factory):
    n = {"debug": 4, "debug-pod": 8}[request.param]
    ranks = worker.spawn(n, str(tmp_path_factory.mktemp(f"tp{n}")),
                         {"tp": inputs}, "tp")
    return DATA_RANKS[request.param], ranks


def _data_pieces(rows, d):
    """[start, stop) of each data rank's rows, in data-rank order: each data
    axis splits what the one before it left, as ``torch.chunk`` does."""
    pieces = [(0, rows)]
    for size in DATA_AXES[d]:
        nxt = []
        for a, b in pieces:
            c = -(-(b - a) // size)
            nxt += [(min(b, a + i * c), min(b, a + (i + 1) * c))
                    for i in range(size)]
        pieces = nxt
    return pieces


def _decode(params, cfg, tokens):
    """The unmeshed ``decode_step`` of the last column of ``tokens`` on
    the warm cache of the others (``worker.warm_cache``)."""
    cache = worker.warm_cache(cfg, params, tokens)
    return tdlm.decode_step(params, cfg, cache, tokens[:, -1:])[0]


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's unsharded round and forward for each case."""
    out = {}
    for case, inp in inputs.items():
        cfg = inp["cfg"]
        params = bridge.from_numpy_tree(inp["params"], "cpu")
        y, z = tpart.partition(params, cfg.freeze_spec)
        step, sopt = tfedpt.make_round_fn(
            lambda p, mb, cfg=cfg: tdlm.train_loss(p, cfg, mb),
            tfedpt.RoundConfig(**RC), device="cpu")
        y_new, _, m = step(y, sopt.init(y), z,
                           {k: torch.as_tensor(v)
                            for k, v in inp["batch"].items()},
                           torch.ones(R["clients"]), None)
        logits = tdlm.forward(params, cfg, torch.as_tensor(
            inp["prefill"]))[0].float().numpy()
        out[case] = {"y0": [t.numpy() for t in tbasic.tree_leaves(y)],
                     "y": [t.numpy() for t in tbasic.tree_leaves(y_new)],
                     "loss": float(m["loss"]), "logits": logits}
        if "decode" in inp:
            out[case]["decode"] = _decode(
                params, cfg, torch.as_tensor(inp["decode"])).float().numpy()
    return out


@pytest.fixture(scope="module")
def reference(inputs):
    """The reference's round and forward for the float32 cases."""
    out = {}
    for case, inp in inputs.items():
        if "bf16" in case:
            continue
        jcfg = _jcfg(case)
        jp = jax.tree_util.tree_map(jnp.asarray, inp["params"])
        jy, jz = jpart.partition(jp, jcfg.freeze_spec)
        jround, jsopt = jfedpt.make_round_fn(
            lambda p, mb, jcfg=jcfg: jdlm.train_loss(p, jcfg, mb),
            jfedpt.RoundConfig(**RC))
        jy_new, _, jm = jround(jy, jsopt.init(jy), jz,
                               {k: jnp.asarray(v)
                                for k, v in inp["batch"].items()},
                               jnp.ones((R["clients"],), jnp.float32),
                               jax.random.key(0))
        logits = np.asarray(jdlm.forward(jp, jcfg,
                                         jnp.asarray(inp["prefill"]))[0])
        out[case] = {"y": [np.asarray(t) for t in
                           jax.tree_util.tree_leaves(jy_new)],
                     "loss": float(jm["loss"]), "logits": logits}
        if "decode" in inp:
            tok = jnp.asarray(inp["decode"])
            cache = jdlm.init_cache(jcfg, tok.shape[0],
                                    worker.DECODE_MAX_LEN)
            for i in range(tok.shape[1]):
                lg, cache = jdlm.decode_step(jp, jcfg, cache, tok[:, i:i + 1])
            out[case]["decode"] = np.asarray(lg)
    return out


def _leaves(tree):
    return [np.asarray(v) for _, v in tbasic.flatten_params(tree)]


def _update_gap(y0, want, got) -> float:
    """||got - want|| / ||want - y0|| over the whole tree, in float64."""
    num = sum(float(((a.astype(np.float64) - b) ** 2).sum())
              for a, b in zip(want, got))
    den = sum(float(((a.astype(np.float64) - b) ** 2).sum())
              for a, b in zip(want, y0))
    return (num / den) ** 0.5


def _bf16_bounds(unsharded, case):
    """A bf16 case's bounds: the unsharded bf16 round's own distance from
    its float32 twin, by update norm and by the largest |logit|."""
    lo, hi = unsharded[_twin(case)], unsharded[case]
    upd = _update_gap(lo["y0"], lo["y"], hi["y"])
    lg = float(np.abs(hi["logits"] - lo["logits"]).max()
               / np.abs(lo["logits"]).max())
    return upd, lg


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_matches_the_unsharded_round(world, unsharded, case):
    want = unsharded[case]
    y, loss, _ = world[1][0][case]["runs"][0]
    rel = (_bf16_bounds(unsharded, case)[0] if "bf16" in case
           else UPDATE_REL)
    assert _update_gap(want["y0"], want["y"], _leaves(y)) <= rel
    assert loss == pytest.approx(want["loss"], rel=rel)


@pytest.mark.parametrize("case", [c for c in CASES if "bf16" not in c])
def test_tp_train_step_matches_the_reference(world, unsharded, reference,
                                             case):
    y, loss, _ = world[1][0][case]["runs"][0]
    assert _update_gap(unsharded[case]["y0"], reference[case]["y"],
                       _leaves(y)) <= JAX_UPDATE_REL
    assert loss == pytest.approx(reference[case]["loss"], rel=JAX_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_tp_prefill_matches_the_unsharded_forward(world, unsharded, case):
    """The meshed prefill of rows split over the data ranks against the
    forward of the whole batch."""
    ranks = world[1]
    got = ranks[0][case]["logits"]
    want = unsharded[case]["logits"]
    rel = (_bf16_bounds(unsharded, case)[1] if "bf16" in case
           else LOGIT_REL)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())
    assert ranks[0][case]["logit_placements"].endswith("Shard(dim=2))")


@pytest.mark.parametrize("case", [c for c in CASES if "bf16" not in c])
def test_tp_prefill_matches_the_reference(world, reference, case):
    np.testing.assert_allclose(world[1][0][case]["logits"],
                               reference[case]["logits"], rtol=JAX_TOL,
                               atol=JAX_TOL)


@pytest.mark.parametrize("case", list(DECODE))
def test_mesh_decode_matches_the_unsharded_decode_step(world, unsharded,
                                                       case):
    """The meshed decode of B rows split over the data ranks against the
    unmeshed ``decode_step`` of all B rows (the same warm cache), on every
    rank."""
    want = unsharded[case]["decode"]
    for rank in world[1]:
        got = rank[case]["decode"]
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) \
            <= LOGIT_REL * float(np.abs(want).max())


@pytest.mark.parametrize("case", list(DECODE))
def test_mesh_decode_matches_the_reference(world, reference, case):
    np.testing.assert_allclose(world[1][0][case]["decode"],
                               reference[case]["decode"], rtol=JAX_TOL,
                               atol=JAX_TOL)


@pytest.mark.parametrize("d", sorted(set(DATA_RANKS.values())))
@pytest.mark.parametrize("case", OVERFLOW)
def test_overflow_cases_tell_the_global_batch_from_its_pieces(inputs,
                                                              unsharded, case,
                                                              d):
    """The overflow cases discriminate: forwarding each data rank's rows
    alone (an MoE's capacity counted over those rows) moves the logits by
    more than the prefill's bound, and so would the meshed decode; the
    second case leaves the last data rank of the 2 x 2 x 2 world empty."""
    inp = inputs[case]
    params = bridge.from_numpy_tree(inp["params"], "cpu")
    tok = torch.as_tensor(inp["prefill"])
    pieces = _data_pieces(tok.shape[0], d)
    split = np.concatenate([
        tdlm.forward(params, inp["cfg"], tok[a:b])[0].float().numpy()
        for a, b in pieces if b > a])
    want = unsharded[case]["logits"]
    assert float(np.abs(split - want).max()) \
        > LOGIT_REL * float(np.abs(want).max())
    if case == "mixtral_ffn_overflow" and d == 4:
        assert pieces[-1][0] == pieces[-1][1]
    if case in DECODE:
        dec = torch.as_tensor(inp["decode"])
        split = np.concatenate([
            _decode(params, inp["cfg"], dec[a:b]).float().numpy()
            for a, b in _data_pieces(dec.shape[0], d)])
        want = unsharded[case]["decode"]
        assert float(np.abs(split - want).max()) \
            > LOGIT_REL * float(np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_repeats_bit_for_bit_on_every_rank(world, case):
    ranks = world[1]
    first = ranks[0][case]
    (ya, la, na), (yb, lb, nb) = first["runs"]
    assert (la, na) == (lb, nb)
    for a, b in zip(_leaves(ya), _leaves(yb)):
        np.testing.assert_array_equal(a, b)
    for other in ranks[1:]:
        for a, b in zip(_leaves(ya), _leaves(other[case]["runs"][0][0])):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(first["logits"], other[case]["logits"])


@pytest.mark.parametrize("case", list(CASES))
def test_frozen_tree_stays_in_pieces(world, case):
    """Each rank holds its pieces of the frozen tree, placed by the rules:
    a split leaf's local elements are the whole leaf's over the 2-wide
    "model" axis; the experts (or the dense FFN) and the embedding are
    split; and the decoder LM's ``train_loss`` (in both runs of the step)
    and ``forward`` (in the prefill) receive exactly those pieces, every
    frozen leaf of them, so no step makes a frozen leaf whole before its
    layers run. The new y keeps the rules' placements; the job's layout
    is the tensor-parallel one."""
    for rank in world[1]:
        res = rank[case]
        split = {p for p, (n, whole, dt) in res["frozen_local"].items()
                 if dt and n != whole}
        for p, (n, whole, dt) in res["frozen_local"].items():
            assert dt and n * (2 if p in split else 1) == whole, p
            for seen in res["frozen_seen"].values():
                assert seen[p] == {n}, (p, seen[p], n, whole)
        arch = CASES[case][0]
        kinds = (("/moe/wi_gate", "/moe/wi_up", "/moe/wo") if "mixtral"
                 in arch else ("/ffn/wi_gate/kernel", "/ffn/wo/kernel"))
        assert all(any(p.endswith(k) for p in split) for k in kinds), split
        assert res["layout"] == specs.TP_LAYOUT
        pl = res["y_placements"]
        assert pl["layers/slot0/attn/wq/kernel"].endswith("Shard(dim=2))")
        assert "Shard" not in pl["final_norm/scale"]
