"""The 2-round ``run_reduced_arch`` histories of the reduced Jamba-v0.1
and xLSTM-350M (``launch/train.reduced_config``: d_model 256, 4 heads,
vocab 512, float32 compute; Jamba 8 layers with 4 experts, xLSTM 4)
against the JAX package's, from the same seed: both runs' losses, the
billed bytes, and the trained y by update norm.

Tolerances. The xLSTM's losses within rel 1e-4 and its trained y within
1e-3 of ||dy_jax|| (``tests/test_torch_zoo.py``'s bounds). The reduced
Jamba's training is chaotic: a relative perturbation of 1e-7 of its
initial weights moves the port's own 2-round run by 1.7e-2 of ||dy||
and its second loss by 7e-5 rel (with or without its experts; measured
on the CPU), so its history is held to the first loss within 1e-5 rel,
the second within 5e-4 and y by update norm within 5e-2. Each arch is a
test of its own here, apart from ``tests/test_torch_ssm.py``, since the
reference's round engine takes long to compile.
"""
import dataclasses

import numpy as np
import pytest

import repro  # noqa: F401

import repro.core.partition as jpart
from repro.launch.train import run_reduced_arch as jrun_reduced_arch
from repro.models import decoder_lm as jdlm
from repro.nn import basic as jbasic
from repro_torch.launch import train as ttrain
from repro_torch.nn import basic as tbasic

# (loss rel of round 1, of round 2, update-norm rel) of the 2-round history
HISTORY_TOL = {"xlstm-350m": (1e-4, 1e-4, 1e-3),
               "jamba-v0.1-52b": (1e-5, 5e-4, 5e-2)}


@pytest.mark.parametrize("arch", sorted(HISTORY_TOL))
def test_run_reduced_arch_matches_the_reference(arch):
    first, second, update_rel = HISTORY_TOL[arch]
    jres, jcfg = jrun_reduced_arch(arch, 2, log=False)
    tres, tcfg = ttrain.run_reduced_arch(arch, 2, log=False, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jl = [h["loss"] for h in jres.history]
    tl = [h["loss"] for h in tres.history]
    assert len(tl) == 2 and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[0], jl[0], rtol=first)
    np.testing.assert_allclose(tl[1], jl[1], rtol=second)
    assert tres.comm.trainable_bytes == jres.comm.trainable_bytes
    assert tres.comm.full_bytes == jres.comm.full_bytes
    y0 = dict(jbasic.flatten_params(jpart.partition(
        jdlm.init_model(jcfg, 0), jcfg.freeze_spec)[0]))
    jy = dict(jbasic.flatten_params(jres.y))
    ty = dict(tbasic.flatten_params(tres.y))
    assert sorted(ty) == sorted(jy) == sorted(y0)
    diff = step = 0.0
    for path, w in jy.items():
        w, a = np.asarray(w, np.float64), np.asarray(y0[path], np.float64)
        diff += float(((ty[path].double().numpy() - w) ** 2).sum())
        step += float(((w - a) ** 2).sum())
    print(f"{arch} run_reduced_arch: ||dy_port - dy_jax|| / ||dy_jax|| = "
          f"{(diff / step) ** 0.5:.3e}")
    assert diff ** 0.5 <= update_rel * step ** 0.5
