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
expert's entries span data ranks; and one period of each SSM family's
layer program, the reference's ``reduced_config``: xLSTM (3 mLSTM blocks,
``up_proj`` column- and ``down_proj`` row-parallel around a replicated
cell, and an sLSTM block whole on every rank) and Jamba (7 Mamba blocks
on each rank's channels, ``in_proj``'s column block moved to them by an
all-to-all, an attention block without RoPE, dense and MoE FFNs); the
VLM, a reduced PaliGemma with 4 q heads and 1 kv head (the kv head split
in half on the 2-wide axis) and 8 patch embeddings through ``mm_proj``,
which no rule splits and every rank computes whole, as a bidirectional
prefix; and the encoder-decoder, a reduced Whisper whose encoder and
cross-attention run on each rank's heads (k and v from the encoder's
output, replicated on "model"), with an odd vocab of 515, which the
rules leave whole (a whole embedding lookup, whole logits and the plain
cross-entropy under tensor parallelism), and at d_model 192 with 3
heads, 1.5 heads a rank, as Whisper large-v3's 20 are 1.25 a rank on a
16-wide axis. The encoder's trainable leaves are held leaf by leaf:
their gradient comes through the encoder's output, which enters each
decoder layer's cross-attention through ``tp_copy`` once.
The prefill's rows are split over the
data axes (in ``torch.chunk``'s pieces: the second overflow case's 3
rows fall 2, 1 on the 2 x 2 world and 1, 1, 1, 0 on the 2 x 2 x 2 one, a
data rank with no rows; so do PaliGemma's and the split-head Whisper's,
their patch embeddings and frames placed as the tokens), and an MoE
counts its capacity and slot ranks
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

The SSM cases' update is also held leaf by leaf: each leaf's distance,
less one float32 ulp of the new y at each of its elements (in norm), is
within the bound of that leaf's own update. Where a leaf's values are
large beside its step (Mamba's ``A_log`` up to log 16 and ``D`` at 1,
the convolutions' weights), the step is a few ulps of y and two float32
rounds may land an element on neighbouring floats; elsewhere the ulp
term is ~1e-7 of the update. Against the reference they are held at the
file's 1e-4. Against the port's unsharded round they are held at
SSM_UPDATE_REL, 5e-5, not 1e-5: their float32 rounds are
ill-conditioned (moving each element of y by one relative ulp moves the
unsharded round by ~4e-5 of the update for the xLSTM and ~1e-4 for
Jamba; ``tests/test_torch_ssm_history.py`` documents Jamba's
two-round chaos), and the TP rounds sit at 1.03e-5 (xLSTM) and 2.1e-5
(Jamba) of the update over the whole tree, at most 6.8e-6 and 1.65e-5
leaf by leaf (measured on the CPU, both worlds).

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
# the SSM cases, their update held leaf by leaf as well as whole, and
# against the port's unsharded round at SSM_UPDATE_REL
SSM = ("xlstm", "jamba")
SSM_UPDATE_REL = 5e-5
# the encoder-decoder cases' encoder subtree by its plain update norm
# against the port's unsharded round: measured 9.5e-6 and 1.10e-5 on both
# worlds (once 1.16e-5), its float32 steps a few ulps of y, so one-ulp
# rounds add up over the subtree's norm; the leaf-by-leaf measure holds
# it at UPDATE_REL as well
ENC_UPDATE_REL = 2e-5
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
    "deepseek_2d": ("deepseek-v2-236b", {"expert_shard": "2d"}),
    "deepseek_2d_overflow": ("deepseek-v2-236b", {
        "expert_shard": "2d", "moe_capacity_factor": 0.5}),
    "deepseek_split_head": ("deepseek-v2-236b", {"expert_shard": "2d",
                                                 "num_heads": 3}),
    "xlstm": ("xlstm-350m", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "paligemma": ("paligemma-3b", {"num_heads": 4, "num_kv_heads": 1}),
    "whisper_odd_vocab": ("whisper-large-v3", {"vocab_size": 515}),
    "whisper_split_head": ("whisper-large-v3", {"d_model": 192,
                                                "num_heads": 3,
                                                "num_kv_heads": 3}),
}
OVERFLOW = [c for c in CASES if c.endswith("_overflow")]
PREFILL_ROWS = {"mixtral_ffn_overflow": 3, "deepseek_2d_overflow": 3,
                "paligemma": 3, "whisper_split_head": 3}
# the encoder-decoder cases, and those whose vocab does not divide the
# 2-wide "model" axis (its embedding and unembedding replicate, and so do
# the prefill's logits)
ENC_DEC = [c for c in CASES if CASES[c][0] == "whisper-large-v3"]
WHOLE_VOCAB = ["whisper_odd_vocab"]
# the round's clients (else TP_ROUND's 4): 3 do not divide the data ranks,
# 2, 1 on 2 x 2 and 1, 1, 1, 0 on 2 x 2 x 2, so a short rank pads its rows
# to join every expert exchange, and the last rank of 2 x 2 x 2 trains none
CLIENTS = {"deepseek_2d_overflow": 3}
# the 2-D expert cases: each routed expert stack holds 1 / (D * M) of the
# bank a rank (the expert dim on the 2-wide "data" axis, the FFN dim on
# the 2-wide "model" axis; "pod" replicates)
TWO_D = [c for c in CASES if CASES[c][1].get("expert_shard") == "2d"]
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
        clients = CLIENTS.get(case, R["clients"])
        tok = rng.integers(0, jcfg.vocab_size,
                           (clients, R["tau"], R["batch"], R["seq"]),
                           dtype=np.int32)
        rows = PREFILL_ROWS.get(case, 4)
        out[case] = {"arch": CASES[case][0], "cfg": _tcfg(case),
                     "params": params,
                     "batch": {"tokens": tok, "labels": tok},
                     "prefill": rng.integers(0, jcfg.vocab_size,
                                             (rows, R["seq"]),
                                             dtype=np.int32),
                     "prefill_stub": {}}
        # the VLM's patch embeddings, the encoder-decoder's frames: each
        # sentence's in the round, each row's in the prefill
        stub = (("prefix_embeds", (jcfg.num_prefix_tokens,
                                   tdlm.VISION_TOWER_DIM))
                if jcfg.family == "vlm" else
                ("encoder_embeds", (jcfg.encoder_seq_len, jcfg.d_model))
                if jcfg.is_encoder_decoder else None)
        if stub is not None:
            name, shape = stub
            out[case]["batch"][name] = rng.standard_normal(
                (clients, R["tau"], R["batch"]) + shape).astype(np.float32)
            out[case]["prefill_stub"][name] = rng.standard_normal(
                (rows,) + shape).astype(np.float32)
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
                           torch.ones(inp["batch"]["tokens"].shape[0]), None)
        logits = tdlm.forward(params, cfg, torch.as_tensor(inp["prefill"]),
                              **{k: torch.as_tensor(v) for k, v in
                                 inp["prefill_stub"].items()})[0]
        logits = logits.float().numpy()
        out[case] = {"paths": [p for p, _ in tbasic.flatten_params(y)],
                     "y0": [t.numpy() for t in tbasic.tree_leaves(y)],
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
                               jnp.ones((inp["batch"]["tokens"].shape[0],),
                                        jnp.float32),
                               jax.random.key(0))
        logits = np.asarray(jdlm.forward(
            jp, jcfg, jnp.asarray(inp["prefill"]),
            **{k: jnp.asarray(v) for k, v in inp["prefill_stub"].items()})[0])
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


def _leaf_excess(y0, want, got) -> float:
    """The worst leaf's ||got - want|| less one float32 ulp of ``want``
    at each element (in norm), over its update ||want - y0||."""
    worst = 0.0
    for a0, a, b in zip(y0, want, got):
        a = a.astype(np.float64)
        ulp = np.linalg.norm(np.spacing(np.abs(a).astype(np.float32))
                             .astype(np.float64))
        excess = np.linalg.norm(a - b) - ulp
        if excess > 0:
            worst = max(worst, excess / np.linalg.norm(a - a0))
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_tp_train_step_matches_the_unsharded_round(world, unsharded, case):
    want = unsharded[case]
    y, loss, _ = world[1][0][case]["runs"][0]
    rel = (_bf16_bounds(unsharded, case)[0] if "bf16" in case
           else SSM_UPDATE_REL if case in SSM else UPDATE_REL)
    assert _update_gap(want["y0"], want["y"], _leaves(y)) <= rel
    if case in SSM:
        assert _leaf_excess(want["y0"], want["y"], _leaves(y)) <= rel
    assert loss == pytest.approx(want["loss"], rel=rel)


@pytest.mark.parametrize("case", [c for c in CASES if "bf16" not in c])
def test_tp_train_step_matches_the_reference(world, unsharded, reference,
                                             case):
    y, loss, _ = world[1][0][case]["runs"][0]
    y0 = unsharded[case]["y0"]
    assert _update_gap(y0, reference[case]["y"], _leaves(y)) <= JAX_UPDATE_REL
    if case in SSM:
        assert _leaf_excess(y0, reference[case]["y"],
                            _leaves(y)) <= JAX_UPDATE_REL
    assert loss == pytest.approx(reference[case]["loss"], rel=JAX_TOL)


@pytest.mark.parametrize("case", ENC_DEC)
def test_tp_encoder_leaves_match_the_unsharded_round(world, unsharded, case):
    """The encoder's trainable leaves (its attention and norms, and
    ``enc_norm``) against the unsharded round: their gradient comes
    through the encoder's output, which every decoder layer's
    cross-attention reads on each rank's heads. Were that output's
    gradient summed over "model" at no use (or twice at one), the
    encoder's update would be half (or twice) the unsharded one. Held by
    the subtree's plain update norm at ENC_UPDATE_REL, and leaf by leaf
    as the SSM cases are (``_leaf_excess``: the attention kernels' steps
    are a few float32 ulps of y, so two rounds of the same update may
    land an element on neighbouring floats) at UPDATE_REL; measured at
    most 1.10e-5 and 6.7e-7 on the CPU, both worlds. The encoder
    output's gradient scaled by 1 + 5e-6 in every decoder layer reads
    2.6e-5 and 5.0e-6 on 2 x 2 (the plain norm fails it); by 1 + 2e-5,
    4.7e-5 and 2.0e-5 (both fail it)."""
    want = unsharded[case]
    got = dict(tbasic.flatten_params(world[1][0][case]["runs"][0][0]))
    enc = [i for i, p in enumerate(want["paths"]) if p.startswith("enc_")]
    assert len(enc) >= 8
    y0, yw = [want["y0"][i] for i in enc], [want["y"][i] for i in enc]
    yg = [np.asarray(got[want["paths"][i]]) for i in enc]
    assert _update_gap(y0, yw, yg) <= ENC_UPDATE_REL
    assert _leaf_excess(y0, yw, yg) <= UPDATE_REL


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
    assert ranks[0][case]["logit_placements"].endswith(
        "Replicate())" if case in WHOLE_VOCAB else "Shard(dim=2))")


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
    if PREFILL_ROWS.get(case) == 3 and d == 4:
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


EXPERTS = ("/moe/wi_gate", "/moe/wi_up", "/moe/wo")
DENSE_FFN = ("/ffn/wi_gate/kernel", "/ffn/wo/kernel")
# the frozen leaf kinds the rules split, by arch (else the dense FFN's)
SPLIT_FROZEN = {
    "mixtral-8x7b": EXPERTS, "deepseek-v2-236b": EXPERTS,
    "xlstm-350m": ("/mlstm/up_proj/kernel", "/mlstm/down_proj/kernel"),
    "jamba-v0.1-52b": EXPERTS + DENSE_FFN + ("/mamba/in_proj/kernel",
                                             "/mamba/out_proj/kernel"),
    # the encoder's FFNs (ungated), the frozen leaves of the reference's
    # freeze spec
    "whisper-large-v3": ("/ffn/wi/kernel", "/ffn/wo/kernel")}
# the encoder-decoder's attention leaves the rules split: the encoder's,
# and the decoder's cross-attention (q from the decoder, k / v from the
# encoder; wo row-parallel)
WHISPER_PLACED = {"enc_layers/slot0/attn/wq/kernel": "Shard(dim=2))",
                  "enc_layers/slot0/attn/wo/kernel": "Shard(dim=1))",
                  "layers/slot0/cross_attn/wq/kernel": "Shard(dim=2))",
                  "layers/slot0/cross_attn/wv/kernel": "Shard(dim=2))",
                  "layers/slot0/cross_attn/wo/kernel": "Shard(dim=1))",
                  "layers/slot0/ln_cross/scale": "Replicate())"}
# trainable leaves and their placements on the mesh, by arch (the stacked
# leaves' group dim first)
Y_PLACED = {
    "deepseek-v2-236b": {"layers/slot0/attn/wq_b/kernel": "Shard(dim=2))"},
    "xlstm-350m": {"embed/embedding": "Shard(dim=0))",
                   "layers/slot0/mlstm/wq/bias": "Replicate())",
                   "layers/slot3/slstm/w_gates/kernel": "Replicate())"},
    "jamba-v0.1-52b": {
        "layers/slot4/attn/wq/kernel": "Shard(dim=2))",
        "layers/slot0/mamba/x_proj/kernel": "Shard(dim=1))",
        "layers/slot0/mamba/dt_proj/kernel": "Shard(dim=2))",
        "layers/slot0/mamba/dt_proj/bias": "Replicate())",
        "layers/slot0/mamba/conv_w": "Shard(dim=2))",
        "layers/slot0/mamba/conv_b": "Shard(dim=1))",
        "layers/slot0/mamba/A_log": "Shard(dim=1))",
        "layers/slot0/mamba/D": "Shard(dim=1))"},
    # by case: the VLM's mm_proj, which no rule matches, and its single kv
    # head's 64 columns split 32 a rank; Whisper's vocab split, or whole
    # where it does not divide the axis
    "paligemma": {"mm_proj/kernel": "Replicate())",
                  "mm_proj/bias": "Replicate())",
                  "embed/embedding": "Shard(dim=0))",
                  "layers/slot0/attn/wk/kernel": "Shard(dim=2))"},
    "whisper_odd_vocab": {**WHISPER_PLACED,
                          "embed/embedding": "Replicate())",
                          "unembed/kernel": "Replicate())"},
    "whisper_split_head": {**WHISPER_PLACED,
                           "embed/embedding": "Shard(dim=0))",
                           "unembed/kernel": "Shard(dim=1))"}}


@pytest.mark.parametrize("case", list(CASES))
def test_frozen_tree_stays_in_pieces(world, case):
    """Each rank holds its pieces of the frozen tree, placed by the rules:
    a split leaf's local elements are the whole leaf's over the 2-wide
    "model" axis; the experts (or the dense FFN), Mamba's ``in_proj`` /
    ``out_proj``, the mLSTM's ``up_proj`` / ``down_proj`` and the
    embedding are split; and the decoder LM's ``train_loss`` (in both
    runs of the step) and ``forward`` (in the prefill) receive exactly
    those pieces, every frozen leaf of them, so no step makes a frozen
    leaf whole before its layers run. So do the trainable leaves the
    rules split (Mamba's ``x_proj``, ``dt_proj``, conv, ``A_log`` and
    ``D``: the rank's channels; the encoder's and the cross-attention's
    projections), in the prefill. The new y keeps the rules' placements
    (the sLSTM and the mLSTM's cell replicated, the VLM's ``mm_proj``
    whole, an odd vocab whole); the job's layout is the tensor-parallel
    one."""
    arch = CASES[case][0]
    placed = Y_PLACED.get(case, Y_PLACED.get(arch, {}))
    for rank in world[1]:
        res = rank[case]
        split = {p for p, (n, whole, dt) in res["frozen_local"].items()
                 if dt and n != whole}
        for p, (n, whole, dt) in res["frozen_local"].items():
            parts = (4 if case in TWO_D and p.endswith(EXPERTS) else
                     2 if p in split else 1)
            assert dt and n * parts == whole, p
            for seen in res["frozen_seen"].values():
                assert seen[p] == {n}, (p, seen[p], n, whole)
        kinds = SPLIT_FROZEN.get(arch, DENSE_FFN)
        assert all(any(p.endswith(k) for p in split) for k in kinds), split
        for p, (n, whole) in res["y_local"].items():
            assert res["frozen_seen"]["prefill"][p] == {n}, p
            if p in placed:
                assert (n * 2 == whole) == ("Shard" in placed[p]), p
        assert res["layout"] == specs.TP_LAYOUT
        pl = res["y_placements"]
        want = placed or {"layers/slot0/attn/wq/kernel": "Shard(dim=2))"}
        for p, w in want.items():
            assert pl[p].endswith(w), (p, pl[p])
        assert "Shard" not in pl["final_norm/scale"]


def test_fedavg_2d_experts_raise_naming_the_leaf():
    """DeepSeek-V2 under FedAvg (``freeze_spec=()``) with 2-D experts: the
    rules place the now trainable expert stacks on "data", over which a
    client's copy of y cannot be split, so the tensor-parallel train step
    refuses them with a ValueError naming the first such leaf. The
    reference cannot place such a leaf either: tracing its train step on a
    1 x 1 ("data", "model") mesh raises, because its per-client
    ``constrain`` prepends the data axis to the leaf's spec, which then
    names "data" twice (``PartitionSpec('data', None, 'data', None,
    'model')``)."""
    from jax.sharding import Mesh

    from repro.launch import specs as jspecs
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import sharding as tshard
    cfg = _tcfg("deepseek_2d").with_(freeze_spec=())
    y, _ = specs.param_structs(cfg)
    mesh = tmesh.AbstractMesh((2, 2), ("data", "model"))
    assert tshard.tensor_parallel_ok(cfg, mesh)
    with pytest.raises(ValueError, match=r"trainable leaf "
                       r"layers/slot0/moe/wi_gate is placed on the data "
                       r"axis 'data'"):
        specs.make_train_step(cfg, mesh, y, device="cpu")
    # under FedPT the same stacks are frozen, and the step builds
    y_pt, _ = specs.param_structs(_tcfg("deepseek_2d"))
    tshard.check_trainable_placements(
        tshard.param_shardings(y_pt, _tcfg("deepseek_2d"), mesh), mesh)

    jcfg = _jcfg("deepseek_2d").with_(freeze_spec=())
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    ys, zs = jspecs.param_structs(jcfg)
    step, sopt = jspecs.make_train_step(jcfg, jmesh, ys)
    tok = jax.ShapeDtypeStruct((1, 2, 1, 16), jnp.int32)
    with pytest.raises(Exception, match="duplicate entries for `data`"):
        jax.eval_shape(step, ys, jax.eval_shape(sopt.init, ys), zs,
                       {"tokens": tok, "labels": tok},
                       jax.ShapeDtypeStruct((1,), jnp.float32),
                       jax.ShapeDtypeStruct((1,), jnp.int32))
