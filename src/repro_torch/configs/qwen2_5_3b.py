"""Qwen2.5-3B-class dense model [hf:Qwen/Qwen2.5-0.5B family card] —
GQA (kv=2), QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
    freeze_spec=(r"/ffn/(wi_gate|wi_up|wo)/kernel$",),
    source="hf:Qwen/Qwen2.5-0.5B",
))
