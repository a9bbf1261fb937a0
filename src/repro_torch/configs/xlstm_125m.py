"""xlstm-125m [ssm] — alternating mLSTM + sLSTM blocks, no FFN (d_ff=0).
[arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=192,
        block_pattern=("mlstm", "slstm"),
        grad_accum=4,
    )
