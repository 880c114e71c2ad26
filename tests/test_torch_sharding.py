"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), on the CPU.

For every architecture at full width (the port's init on the meta
device, ``jax.eval_shape`` in the reference) and at the (16, 16),
(2, 16, 16) and (2, 4) mesh shapes, the port's placements, read back as
the reference's spec, equal the reference's spec of each leaf of ``y``
and ``frozen``, in every ``expert_shard`` mode; the cache placements of
the serving shapes likewise. The reference's rules need only a mesh's
``axis_names`` and ``devices.shape`` (a duck-typed mesh); its
``NamedSharding`` is read as the bare spec. Also: ``maybe_constrain``
on a DTensor of a 1-rank mesh, and which families' steps run tensor-
parallel (``tensor_parallel_ok``).
"""
import functools
import types

import numpy as np
import pytest
import torch

import repro  # noqa: F401
import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS, get_config as jget_config
from repro.configs import load_all as jload_all
from repro.core import partition as jpart
from repro.launch import sharding as jshard
from repro.models import decoder_lm as jdlm
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import load_all as tload_all
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshard
from repro_torch.launch import specs as tspecs
from repro_torch.models import decoder_lm as tdlm
from repro_torch.nn import basic as tbasic

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 4): ("data", "model")}
MODES = ("auto", "model", "2d", "2d_swapped", "ffn")


def duck(shape):
    return types.SimpleNamespace(axis_names=MESHES[shape],
                                 devices=np.empty(shape, dtype=object))


@pytest.fixture(autouse=True)
def _bare_specs(monkeypatch):
    monkeypatch.setattr(jshard, "NamedSharding", lambda mesh, spec: spec)


@functools.lru_cache(maxsize=None)
def ref_structs(arch):
    jload_all()
    cfg = jget_config(arch)
    full = jax.eval_shape(lambda: jdlm.init_model(cfg, 0))
    return jpart.partition(full, cfg.freeze_spec)


@functools.lru_cache(maxsize=None)
def port_structs(arch):
    tload_all()
    return tspecs.param_structs(tget_config(arch))


def ref_spec(spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(tuple(a) if isinstance(a, (tuple, list)) else a
                 for a in spec)


def flat(tree):
    out = {}
    for path, leaf in tbasic.flatten_params(tree):
        out[path] = leaf
    return out


def held_to_reference(jspecs, tplacements, structs, mesh):
    js, tp, st = flat(jspecs), flat(tplacements), flat(structs)
    assert set(js) == set(tp)
    for path, pl in tp.items():
        ndim = len(st[path].shape)
        assert tshard.spec_of(pl, mesh, ndim) == ref_spec(js[path], ndim), \
            path


@pytest.mark.parametrize("shape", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_param_placements_match_reference(arch, shape):
    jy, jz = ref_structs(arch)
    ty, tz = port_structs(arch)
    mesh = tmesh.AbstractMesh(shape, MESHES[shape])
    assert {p: tuple(v.shape) for p, v in flat(ty).items()} == \
        {p: tuple(v.shape) for p, v in flat(jy).items()}
    for mode in MODES:
        jcfg = jget_config(arch).with_(expert_shard=mode)
        tcfg = tget_config(arch).with_(expert_shard=mode)
        for jt, tt in ((jy, ty), (jz, tz)):
            held_to_reference(jshard.param_shardings(jt, jcfg, duck(shape)),
                              tshard.param_shardings(tt, tcfg, mesh), tt,
                              mesh)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_cache_placements_match_reference(arch, shape):
    jload_all()
    tload_all()
    info = tspecs.SHAPES[shape]
    jcfg = jget_config(arch)
    tcfg = tspecs.serving_config(tget_config(arch), shape)
    from repro.launch import specs as jspecs
    jcfg = jspecs.serving_config(jcfg, shape)
    jcache = jax.eval_shape(lambda: jdlm.init_cache(
        jcfg, info["global_batch"], info["seq"], dtype=jnp.bfloat16))
    tcache = tdlm.init_cache(tcfg, info["global_batch"], info["seq"],
                             dtype=torch.bfloat16, device="meta")
    long_ctx = shape == "long_500k"
    for mshape in ((16, 16), (2, 16, 16)):
        mesh = tmesh.AbstractMesh(mshape, MESHES[mshape])
        js = flat(jshard.cache_shardings(jcache, jcfg, duck(mshape),
                                         long_ctx))
        tp = flat(tshard.cache_shardings(tcache, tcfg, mesh, long_ctx))
        tc = flat(tcache)
        assert set(js) == set(tp)
        for path, pl in tp.items():
            ndim = len(getattr(tc[path], "shape", ()))
            assert tshard.spec_of(pl, mesh, ndim) == \
                ref_spec(js[path], ndim), path


@pytest.mark.parametrize("shape", list(MESHES))
def test_flat_and_batch_rules_match_reference(shape):
    """``batch_sharding`` (the cohort rule too): the leading axis on the
    data axes when they divide it, replicated otherwise."""
    mesh = tmesh.AbstractMesh(shape, MESHES[shape])
    for n in (1, 2, 4, 32, 256, 512):
        s = jax.ShapeDtypeStruct((n, 3), jnp.float32)
        want = ref_spec(jshard.batch_sharding(s, duck(shape)), 2)
        got = tshard.batch_sharding(torch.empty((n, 3), device="meta"),
                                    mesh)
        assert tshard.spec_of(got, mesh, 2) == want, n


def test_chunk_ranges_split_as_torch_chunk():
    for n in range(0, 12):
        for parts in (1, 2, 3, 4, 8):
            want = [len(c) for c in torch.arange(n).chunk(parts)] if n \
                else []
            got = [b - a for a, b in (tshard.chunk_range(n, parts, i)
                                      for i in range(parts))]
            assert got[:len(want)] == want and not any(got[len(want):])


def test_maybe_constrain_on_a_one_rank_mesh():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = tmesh.resolve_mesh("single", "cpu")
    x = torch.arange(24.0).reshape(4, 6)
    dx = tshard.distribute(x, mesh, (Replicate(), Replicate()))
    assert tbasic.maybe_constrain(dx, ("model", None)) is dx    # no mesh
    with tmesh.use_mesh(mesh):
        out = tbasic.maybe_constrain(dx, ("model", "galaxy"))
        assert isinstance(out, DTensor)
        assert out.placements == (Replicate(), Shard(0))
        assert torch.equal(out.full_tensor(), x)
        assert tbasic.maybe_constrain(x, ("model", None)) is x  # plain
        assert tbasic.maybe_constrain(dx, (None, None)) is dx
    assert tmesh.get_abstract_mesh() is None


# the presets of the tensor-parallel CPU tests and the production mesh
TP_MESHES = {"debug": ((2, 2), ("data", "model")),
             "debug-pod": ((2, 2, 2), ("pod", "data", "model")),
             "production": ((16, 16), ("data", "model"))}


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "xlstm-350m",
                                  "jamba-v0.1-52b", "paligemma-3b",
                                  "whisper-large-v3"])
def test_tensor_parallel_ok_by_family(arch, mesh_name):
    """DeepSeek-V2 (MLA, its 160 experts in the ``2d`` mode: the expert
    dim on "data", the FFN dim on "model"), the SSM family (xLSTM: the
    mLSTM's projections split, the sLSTM whole), the hybrid (Jamba:
    Mamba on each rank's channels, its 16 experts in the ``model`` mode),
    the VLM (PaliGemma: its ``mm_proj`` whole, its single kv head split)
    and the encoder-decoder (Whisper: the encoder and the cross-attention
    on each rank's heads, its vocab of 51,866 whole on a 4- or 16-wide
    axis) take the tensor-parallel steps on every preset."""
    tload_all()
    cfg = tget_config(arch)
    mesh = tmesh.AbstractMesh(*TP_MESHES[mesh_name])
    assert tshard.tensor_parallel_ok(cfg, mesh)
    if cfg.num_experts:
        assert tshard.expert_mode(cfg, mesh) == {
            "deepseek-v2-236b": "2d", "jamba-v0.1-52b": "model"}[arch]


@pytest.mark.parametrize("mesh_name", list(TP_MESHES))
def test_tensor_parallel_ok_refuses_only_2d_swapped_experts(mesh_name):
    """The one layout the tensor-parallel steps do not take: experts in
    the ``2d_swapped`` mode (the expert dim on "model", the FFN dim on
    "data"), which keep the gathered layout; every other expert mode of
    the same config, and every config of the zoo, is tensor-parallel."""
    from repro_torch.configs import ARCH_IDS
    tload_all()
    mesh = tmesh.AbstractMesh(*TP_MESHES[mesh_name])
    for arch in ARCH_IDS:
        assert tshard.tensor_parallel_ok(tget_config(arch), mesh), arch
    for arch in ("mixtral-8x7b", "deepseek-v2-236b", "jamba-v0.1-52b"):
        cfg = tget_config(arch)
        for mode in ("model", "ffn", "2d", "auto"):
            assert tshard.tensor_parallel_ok(cfg.with_(expert_shard=mode),
                                             mesh)
        assert not tshard.tensor_parallel_ok(
            cfg.with_(expert_shard="2d_swapped"), mesh)
    assert tshard.tensor_parallel_ok(
        tget_config("paligemma-3b").with_(expert_shard="2d_swapped"), mesh)
