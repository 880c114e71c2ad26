"""Jamba v0.1 52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave (one attention layer per 8), MoE (16 experts top-2) on every
second layer."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=65536,
    num_experts=16, num_experts_per_tok=2, moe_period=2,
    router_aux_loss=0.02,
    attn_period=8,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    use_rope=False,  # Jamba uses no positional encoding (Mamba carries order)
    # FedPT: freeze experts + the large Mamba in/out projections; dt/A/D,
    # conv, gates, router, attention and norms stay trainable.
    freeze_spec=(r"/moe/(wi_gate|wi_up|wo)$",
                 r"/mamba/(in_proj|out_proj)/kernel$",
                 r"/ffn/(wi_gate|wi_up|wo)/kernel$"),
    source="arXiv:2403.19887",
))
