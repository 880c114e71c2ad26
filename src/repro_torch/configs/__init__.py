"""Architecture configs, port of ``repro/configs``. ``load_all()`` imports
every ported per-arch module so the registry is populated;
``get_config(name)`` fetches one, and names the slice that brings an
architecture not ported yet.
"""
import importlib

from repro_torch.configs.base import ModelConfig, get_config, register

_MODULES = ("mistral_nemo_12b",)

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True
