"""GLM-4 9B [hf:THUDM/glm-4-9b] — dense, GQA kv=2, RoPE, SwiGLU."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    qkv_bias=True, rope_theta=1e6,
    freeze_spec=(r"/ffn/(wi_gate|wi_up|wo)/kernel$",),
    source="hf:THUDM/glm-4-9b",
))
