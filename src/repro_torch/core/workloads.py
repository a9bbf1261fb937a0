"""LLaMA / ResNet workload shape catalogues for the paper's evaluation
(port of ``repro.core.workloads``).

Fig. 10 runs the FC layers of LLaMA 1/2/3; Fig. 12 the attention GEMMs at
sequence length 2048 (first transformer block, Sec. 5.1 — all blocks are
identical). Shapes follow the public model cards.
"""
from __future__ import annotations

from repro_torch.core.costmodel import Gemm

__all__ = ["llama_fc_gemms", "llama_attention_gemms", "resnet18_gemms",
           "LLAMA_DIMS"]

# model: (d_model, d_ff, n_heads, n_kv_heads)
LLAMA_DIMS = {
    "llama1-7b": (4096, 11008, 32, 32),
    "llama1-13b": (5120, 13824, 40, 40),
    "llama1-30b": (6656, 17920, 52, 52),
    "llama1-65b": (8192, 22016, 64, 64),
    "llama2-7b": (4096, 11008, 32, 32),
    "llama2-13b": (5120, 13824, 40, 40),
    "llama3-8b": (4096, 14336, 32, 8),
}


def llama_fc_gemms(model: str, seq: int = 2048, w_bits: int = 8,
                   a_bits: int = 8) -> list[Gemm]:
    """FC (projection + FFN) GEMMs of one transformer block."""
    d, ff, h, kv = LLAMA_DIMS[model]
    hd = d // h
    return [
        Gemm(d, d, seq, w_bits, a_bits, "wq"),
        Gemm(kv * hd, d, seq, w_bits, a_bits, "wk"),
        Gemm(kv * hd, d, seq, w_bits, a_bits, "wv"),
        Gemm(d, d, seq, w_bits, a_bits, "wo"),
        Gemm(ff, d, seq, w_bits, a_bits, "w_gate"),
        Gemm(ff, d, seq, w_bits, a_bits, "w_up"),
        Gemm(d, ff, seq, w_bits, a_bits, "w_down"),
    ]


def llama_attention_gemms(model: str, seq: int = 2048, bits: int = 8) -> list[Gemm]:
    """Attention-score GEMMs (Q@K^T and P@V per head); K/V act as weights."""
    d, _, h, kv = LLAMA_DIMS[model]
    hd = d // h
    out = []
    for _ in range(h):
        out.append(Gemm(seq, hd, seq, bits, bits, "qk"))
        out.append(Gemm(seq, seq, hd, bits, bits, "pv"))
    return out


def resnet18_gemms(w_bits: int = 4, a_bits: int = 8) -> list[Gemm]:
    """ResNet-18 conv layers as im2col GEMMs (Sec. 5.10), ImageNet 224x224.

    First conv and final FC use 8-bit (Sec. 5.10); the rest w_bits.
    GEMM for conv: n=c_out, k=c_in*k_h*k_w, m=h_out*w_out.
    """
    # (c_in, c_out, kernel, h_out*w_out, repeats)
    layers = [
        (3, 64, 7, 112 * 112, 1),
        (64, 64, 3, 56 * 56, 4),
        (64, 128, 3, 28 * 28, 1), (128, 128, 3, 28 * 28, 3),
        (128, 256, 3, 14 * 14, 1), (256, 256, 3, 14 * 14, 3),
        (256, 512, 3, 7 * 7, 1), (512, 512, 3, 7 * 7, 3),
    ]
    gemms = []
    for i, (cin, cout, ks, hw, rep) in enumerate(layers):
        wb = 8 if i == 0 else w_bits
        for r in range(rep):
            gemms.append(Gemm(cout, cin * ks * ks, hw, wb, a_bits,
                              f"conv{i}_{r}"))
    gemms.append(Gemm(1000, 512, 1, 8, a_bits, "fc"))
    return gemms
