"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA,
head_dim 128 (not d_model/heads), 128k context."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1e6, max_seq_len=131072,
    freeze_spec=(r"/ffn/(wi_gate|wi_up|wo)/kernel$",),
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
