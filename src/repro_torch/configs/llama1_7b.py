"""llama1-7b — the paper's own evaluation model (Sec. 5.1/5.4)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.quant import QuantConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama1-7b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=11008, vocab=32000,
        tie_embeddings=False,
        quant=QuantConfig(mode="none", w_bits=4, a_bits=8, group=128),
    )
