"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b] — dense MHA
(kv=heads), LayerNorm, SwiGLU. (The real model applies RoPE to 25% of
head dims; we apply full RoPE — noted in DESIGN.md.)"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-1.6b", family="dense",
    num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=5632, vocab_size=100352,
    norm_type="layernorm",
    freeze_spec=(r"/ffn/(wi_gate|wi_up|wo)/kernel$",),
    source="hf:stabilityai/stablelm-2-1_6b",
))
