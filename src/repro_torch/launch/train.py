"""Training launcher, port of ``repro/launch/train.py``: so far only
``reduced_config``, the smoke-scale variant the serving CLI and the tests
use (the training loop over the model zoo comes with a later slice)."""
from __future__ import annotations

from repro_torch.models import decoder_lm as dlm


def reduced_config(cfg, max_layers: int = 2, d_model: int = 256,
                   vocab: int = 512):
    """Smoke-scale variant of an assigned architecture (same family/wiring)."""
    slots, _ = dlm.layer_program(cfg)
    period = len(slots)
    layers = max(period, (max_layers + period - 1) // period * period)
    d = min(cfg.d_model, d_model)
    heads = min(cfg.num_heads, max(1, d // 64))
    kvh = max(1, min(cfg.num_kv_heads, heads))
    while heads % kvh:
        kvh -= 1
    return cfg.with_(
        num_layers=layers, d_model=d, num_heads=heads, num_kv_heads=kvh,
        head_dim=d // heads if cfg.head_dim else 0,
        d_ff=min(cfg.d_ff, 4 * d) if cfg.d_ff else 0,
        moe_d_ff=min(cfg.expert_d_ff, 2 * d) if cfg.num_experts else 0,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        vocab_size=min(cfg.vocab_size, vocab),
        kv_lora_rank=min(cfg.kv_lora_rank, 64),
        q_lora_rank=min(cfg.q_lora_rank, 96),
        qk_nope_head_dim=32 if cfg.use_mla else cfg.qk_nope_head_dim,
        qk_rope_head_dim=16 if cfg.use_mla else cfg.qk_rope_head_dim,
        v_head_dim=32 if cfg.use_mla else cfg.v_head_dim,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 16) or 0,
        num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        compute_dtype="float32",
    )
