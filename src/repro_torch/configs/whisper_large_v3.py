"""Whisper large-v3 transformer backbone [arXiv:2212.04356] — 32-layer
encoder + 32-layer decoder with cross-attention, LayerNorm, GELU,
sinusoidal positions, no gating. The mel-spectrogram + conv2 frontend is
a stub: the model takes (B, 1500, 1280) frame embeddings directly."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3", family="audio",
    num_layers=32, d_model=1280, num_heads=20, num_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    is_encoder_decoder=True, encoder_layers=32, encoder_seq_len=1500,
    norm_type="layernorm", act="gelu", gated_mlp=False, use_rope=False,
    # FedPT: freeze encoder FFNs — the paper's own Transformer experiment
    # (SO NWP, Table 11) freezes encoder FFN hidden layers.
    freeze_spec=(r"^enc_layers/.*/ffn/",),
    source="arXiv:2212.04356",
))
