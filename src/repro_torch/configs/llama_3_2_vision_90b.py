"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th
layer; the vision frontend is a stub (the caller provides patch
embeddings as ``batch["context"]``). The reference's ``seq_shard``
(sequence-parallel activations in training) is not a field of the port.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256,
        block_pattern=("attn", "attn", "attn", "attn", "cross"),
        n_context_tokens=1024,
        tie_embeddings=False,
        grad_accum=16,
    )
