"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
early-fusion frontend out of scope (text backbone).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048,
        n_experts=128, top_k=1, n_shared_experts=1,
        block_pattern=("attn",),
        grad_accum=16,
        factored_second_moment=True,
        opt_state_dtype="bfloat16",   # + factored 2nd moment (Adafactor):
                                      # ~790B params cannot hold full f32
                                      # moments
    )
