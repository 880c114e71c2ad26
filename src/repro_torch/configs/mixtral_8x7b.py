"""Mixtral 8x7B [arXiv:2401.04088] — 8-expert top-2 MoE with GQA and
sliding-window attention (window 4096, rolling-buffer KV cache)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    num_experts=8, num_experts_per_tok=2, moe_period=1,
    router_aux_loss=0.02,
    sliding_window=4096, rope_theta=1e6,
    # FedPT: freeze the routed expert FFNs (the dominant parameter block);
    # router, attention and norms stay trainable (paper recipe #1).
    freeze_spec=(r"/moe/(wi_gate|wi_up|wo)$",),
    source="arXiv:2401.04088",
))
