"""Model configuration, port of ``repro/configs/base.py``.

One ``ModelConfig`` describes an architecture; its fields and defaults
are the reference's, so ``ModelConfig(**dataclasses.asdict(jax_cfg))``
builds the port's twin of a JAX config. ``pdtype`` / ``cdtype`` return
torch dtypes. The FedPT freeze specification is a tuple of regexes over
parameter paths (``layers/slot0/ffn/wo/kernel`` style) that selects the
frozen subset.
"""
from __future__ import annotations

import dataclasses
import re

import torch

# Block kinds used by the hybrid / ssm stacks.
ATTN = "attn"
MAMBA = "mamba"
MLSTM = "mlstm"
SLSTM = "slstm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Configuration of a transformer-family model (dense, MoE, hybrid,
    SSM, VLM or audio; the family field selects the stack wiring)."""

    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0          # expert hidden dim (0 -> d_ff)
    router_aux_loss: float = 0.0
    moe_capacity_factor: float = 1.25
    moe_dispatch_groups: int = 0
    expert_shard: str = "auto"
    decode_seq_parallel: bool = False

    # --- MLA (DeepSeek-V2) ----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- attention details ----------------------------------------------------
    qkv_bias: bool = False
    sliding_window: int = 0    # 0 = full attention
    rope_theta: float = 10000.0
    use_rope: bool = True
    attn_logit_softcap: float = 0.0

    # --- hybrid (Jamba) -------------------------------------------------------
    attn_period: int = 0
    moe_period: int = 1

    # --- Mamba ---------------------------------------------------------------
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # --- xLSTM ---------------------------------------------------------------
    slstm_every: int = 0
    xlstm_proj_factor: float = 2.0

    # --- encoder-decoder / multimodal ------------------------------------------
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    num_prefix_tokens: int = 0
    encoder_seq_len: int = 0

    # --- misc ------------------------------------------------------------------
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu | relu
    gated_mlp: bool = True
    tie_embeddings: bool = False
    max_seq_len: int = 32768
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- FedPT ------------------------------------------------------------------
    # regexes over parameter paths selecting the FROZEN subset.
    freeze_spec: tuple = ()
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff else self.d_ff

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def block_kinds(self):
        """Sequence of block kinds (length num_layers)."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "hybrid" and self.attn_period:
                kinds.append(ATTN if (i % self.attn_period) == self.attn_period // 2 else MAMBA)
            elif self.family == "ssm":
                if self.slstm_every and (i % self.slstm_every) == self.slstm_every - 1:
                    kinds.append(SLSTM)
                else:
                    kinds.append(MLSTM)
            else:
                kinds.append(ATTN)
        return kinds

    def layer_uses_moe(self, i: int) -> bool:
        if self.num_experts <= 0:
            return False
        return (i % self.moe_period) == (self.moe_period - 1)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Registry

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        from repro_torch import configs as _c
        _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    """The registry: every ported architecture's config by name."""
    from repro_torch import configs as _c
    _c.load_all()
    return dict(_REGISTRY)


def match_freeze(path: str, freeze_spec) -> bool:
    """True if a parameter path is frozen under the spec."""
    return any(re.search(pat, path) for pat in freeze_spec)
