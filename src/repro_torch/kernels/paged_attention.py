"""Live-page paged-attention decode kernel (CUDA C++,
``csrc/paged_attention.cu``).

Replaces the Pallas kernel ``repro/kernels/paged_attention.py``
(``paged_attention``) in the layout the serving path uses: an int8 KV pool
with stored f32 per-position scales under dynamic int8 attention
(``kv_cache_bits=8``, ``quant_attention=True``). The reference's other
three layouts (exact pool, or int8 pool without quantized attention) are
not ported yet and raise ``NotImplementedError`` on every device.

:func:`paged_attention` quantizes q per token in q's own dtype (as the
reference's wrapper does), then on CUDA tensors launches one block per
(slot, KV head) that walks only the slot's live pages; on CPU tensors it
runs :func:`paged_attention_plain`, the gather + ``attend_cached`` path.
Each launch adds one to ``paged_attention.launches``. The kernel's softmax
sums in another order than the plain version, so the two agree within a
tolerance (see ``chip_smoke.py``), not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.quant.quantize import quantize_per_token

__all__ = ["paged_attention", "paged_attention_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_attention_launch.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P, _P]
        lib.paged_attention_launch.restype = _I
        lib.paged_attention_error.argtypes = [_I]
        lib.paged_attention_error.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check_layout(pool, cfg) -> None:
    if not (cfg.quant_attention and pool["k"].dtype == torch.int8):
        raise NotImplementedError(
            "the paged-attention kernel covers the int8 pool with quantized "
            "attention (kv_cache_bits=8, quant_attention=True); the other "
            "pool layouts decode through the gather path (kernel=False)")


def paged_attention_plain(q, pool, page_indices, steps, cfg, scale):
    """The plain version: gather the full page extent, mask, attend
    (``models.attention.attend_paged_gather``)."""
    from repro_torch.models.attention import attend_paged_gather
    _check_layout(pool, cfg)
    return attend_paged_gather(q, pool, page_indices, steps, cfg, scale)


def paged_attention(q, pool, page_indices, steps, cfg, scale):
    """Live-page decode attention. ``q`` (B, 1, H, hd) post-RoPE; ``pool``
    one layer's leaves ``k``/``v`` (n_pages, ps, KV, hd) int8 and
    ``ks``/``vs`` (n_pages, ps, KV, 1) f32; ``page_indices`` (B, P) int32;
    ``steps`` (B,) int32, the position written this step. Returns
    (B, 1, H, hd) f32."""
    _check_layout(pool, cfg)
    if q.device.type == "cpu":
        return paged_attention_plain(q, pool, page_indices, steps, cfg,
                                     scale)
    lib = _library()
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    b, sq_len, h, hd = q.shape
    if sq_len != 1:
        raise ValueError(f"decode kernel expects Sq == 1, got {sq_len}")
    n_pages, ps, kvh = pool["k"].shape[:3]
    g = h // kvh
    pages = page_indices.shape[1]
    if hd % 16 or 128 % hd or g > 8:
        raise ValueError(f"kernel needs hd % 16 == 0, 128 % hd == 0 and "
                         f"<= 8 query heads per KV head; got hd={hd}, G={g}")
    leaves = {name: pool[name] for name in ("k", "v", "ks", "vs")}
    for name, a in leaves.items():
        if a.device != q.device or not a.is_contiguous():
            raise ValueError(f"pool leaf {name} must be contiguous on "
                             f"{q.device}")
    table = page_indices.to(device=q.device, dtype=torch.int32).contiguous()
    st = steps.to(device=q.device, dtype=torch.int32).contiguous()
    qq, sqs = quantize_per_token(q.reshape(b, kvh, g, hd))
    qq = qq.contiguous()
    sq32 = sqs.to(torch.float32).reshape(b, kvh, g).contiguous()
    out = torch.empty((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.paged_attention_launch(
        qq.data_ptr(), sq32.data_ptr(), leaves["k"].data_ptr(),
        leaves["v"].data_ptr(), leaves["ks"].data_ptr(),
        leaves["vs"].data_ptr(), table.data_ptr(), st.data_ptr(),
        b, kvh, g, hd, ps, pages, float(scale), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: "
                           f"{lib.paged_attention_error(err).decode()}")
    paged_attention.launches += 1
    return out.reshape(b, 1, h, hd)


paged_attention.launches = 0
