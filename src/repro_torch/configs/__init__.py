"""Architecture configs, port of ``repro/configs``. ``load_all()`` imports
every ported per-arch module so the registry is populated;
``get_config(name)`` fetches one, and names the slice that brings an
architecture not ported yet.
"""
import importlib

from repro_torch.configs.base import (ModelConfig, get_config, list_configs,
                                      register)

_MODULES = (
    "mixtral_8x7b",
    "qwen2_5_3b",
    "mistral_nemo_12b",
    "glm4_9b",
    "stablelm_1_6b",
)

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


# canonical arch-id (CLI --arch) -> module config name, the reference's ten
ARCH_IDS = {
    "mixtral-8x7b": "mixtral-8x7b",
    "deepseek-v2-236b": "deepseek-v2-236b",
    "qwen2.5-3b": "qwen2.5-3b",
    "jamba-v0.1-52b": "jamba-v0.1-52b",
    "mistral-nemo-12b": "mistral-nemo-12b",
    "glm4-9b": "glm4-9b",
    "paligemma-3b": "paligemma-3b",
    "xlstm-350m": "xlstm-350m",
    "whisper-large-v3": "whisper-large-v3",
    "stablelm-1.6b": "stablelm-1.6b",
}
