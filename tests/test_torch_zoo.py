"""The port's model zoo against the JAX package: the registry and each
assigned architecture's config, and the dense architectures (Qwen2.5,
GLM-4, StableLM-2) on their ``reduced_config`` (2 layers, d_model 256, 4
heads, vocab 512, float32 compute) through the four model cases of
``tests/_torch_zoo_cases.py``, which states their tolerances. The other
families run the same cases in ``tests/test_torch_zoo_moe.py`` (Mixtral,
with its decode and training end to end), ``test_torch_zoo_mla.py``
(DeepSeek-V2), ``test_torch_zoo_hybrid.py`` (Jamba) and
``test_torch_zoo_ssm.py`` (xLSTM); PaliGemma and Whisper have
``test_torch_vlm.py`` and ``test_torch_encdec.py``.
"""
import dataclasses

import pytest

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs.base import get_config as jget
from repro.configs.base import list_configs as jlist
from repro.launch.train import reduced_config as jreduced
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.launch import train as ttrain

from _torch_zoo_cases import (  # noqa: F401
    _one_intra_op_thread, pytest_generate_tests,
    test_forward_logits_and_aux_match_jax, test_init_leaves_match_jax,
    test_one_federated_train_step, test_train_loss_and_gradient_match_jax)

ARCHS = ["mixtral-8x7b", "deepseek-v2-236b", "qwen2.5-3b", "glm4-9b",
         "stablelm-1.6b", "jamba-v0.1-52b", "xlstm-350m"]
FAMILY = ["qwen2.5-3b", "glm4-9b", "stablelm-1.6b"]   # the dense archs
# the VLM and the encoder-decoder, whose stacks have their own test files
WAITING = ["paligemma-3b", "whisper-large-v3"]


def test_registry_matches_the_reference():
    assert tconfigs.ARCH_IDS == JARCH_IDS
    ported = tbase.list_configs()
    assert sorted(ported) == sorted(ARCHS + WAITING + ["mistral-nemo-12b"])
    for name, cfg in ported.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jlist()[name])
    assert sorted(ported) == sorted(JARCH_IDS)
    assert not hasattr(tbase, "WAITING")


@pytest.mark.parametrize("arch", WAITING)
def test_waiting_architectures_name_their_module(arch):
    """The two architectures that waited for the VLM prefix and the
    encoder-decoder stack now resolve to the reference's configs, reduced
    ones included."""
    assert arch in JARCH_IDS
    full = jget(arch)
    tcfg = tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(full)
    assert dataclasses.asdict(ttrain.reduced_config(tcfg)) \
        == dataclasses.asdict(jreduced(full))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    full = jget(arch)
    tcfg = tbase.get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(full)
    assert dataclasses.asdict(ttrain.reduced_config(tcfg)) \
        == dataclasses.asdict(jreduced(full))

