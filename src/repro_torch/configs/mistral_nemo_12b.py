"""mistral-nemo-12b [dense] — 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=131072, head_dim=128,
        tie_embeddings=False, rope_theta=1e6,
        grad_accum=8,
    )
