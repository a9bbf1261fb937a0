"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
early-fusion frontend out of scope (text backbone).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

The reference's config also sets ``factored_second_moment`` and a
bfloat16 ``opt_state_dtype`` (its optimizer state at 400B parameters);
those are training fields the port does not keep."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048,
        n_experts=128, top_k=1, n_shared_experts=1,
        block_pattern=("attn",),
        grad_accum=16,
    )
