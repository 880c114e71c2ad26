"""PaliGemma-3B language backbone [arXiv:2407.07726] — Gemma decoder
(MQA kv=1, head_dim 256, GeGLU, tied embeddings) consuming 256 SigLIP
patch embeddings via a linear projector. The SigLIP vision tower is a
stub: the model takes (B, 256, 1152) patch embeddings; the port implements
the language/decoder transformer."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab_size=257216,
    act="gelu", tie_embeddings=True,
    num_prefix_tokens=256,
    freeze_spec=(r"/ffn/(wi_gate|wi_up|wo)/kernel$",),
    source="arXiv:2407.07726",
))
