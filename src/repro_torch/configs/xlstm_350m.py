"""xLSTM-350M [arXiv:2405.04517] — mLSTM (matrix memory, chunkwise
parallel) blocks with an sLSTM (scalar memory) block every 4th layer.
d_ff=0: the cells carry their own up/down projections."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-350m", family="ssm",
    num_layers=24, d_model=1024, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_every=4, xlstm_proj_factor=2.0,
    use_rope=False, tie_embeddings=True,
    # FedPT: freezing the recurrent/projection kernels = the echo-state
    # regime the paper cites (Jaeger 2002); gates & norms stay trainable.
    freeze_spec=(r"/mlstm/(wq|wk|wv|up_proj|down_proj)/kernel$",
                 r"/slstm/(r_gates|up_gate|up_proj|down_proj)"),
    source="arXiv:2405.04517",
))
