"""chatglm3-6b [dense] — 2d (partial) RoPE, GQA kv=2. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=65024,
        rope_2d=True,
        grad_accum=8,
    )
