"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA (kv_lora 512) + 160 routed
experts top-6 with 2 shared experts (expert FFN dim 1536)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=12288, vocab_size=102400,
    num_experts=160, num_experts_per_tok=6, num_shared_experts=2,
    moe_d_ff=1536, moe_period=1, router_aux_loss=0.003,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    # The reference's deviation: the real model keeps layer 0 dense; every
    # one of the 60 layers is MoE here, so the layer program stays one
    # homogeneous group.
    freeze_spec=(r"/moe/(wi_gate|wi_up|wo)$",),
    source="arXiv:2405.04434",
))
