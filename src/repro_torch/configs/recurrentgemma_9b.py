"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rglru.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000,
        block_pattern=("rglru", "rglru", "attn"),
        block_tail=("rglru", "rglru"),
        local_window=2048,
        grad_accum=8,
    )
