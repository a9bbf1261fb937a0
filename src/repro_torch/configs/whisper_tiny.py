"""whisper-tiny [audio] — enc-dec; the conv frontend is a stub (the
caller provides precomputed frame embeddings as ``batch["context"]``).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny", family="audio",
        n_layers=8, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab=51865,
        block_pattern=("attn", "cross"),   # 8 pattern-layers = 4 dec layers
        mlp_after=(1,),                    # whisper layer: self -> cross -> mlp
        encoder_layers=4,
        n_context_tokens=1500,
        max_target_positions=448,
        tie_embeddings=True,
        grad_accum=4,
    )
