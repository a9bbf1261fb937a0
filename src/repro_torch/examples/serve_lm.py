"""Serving example: quantize a model with the paper's technique (W4A8
TransitiveLinear + dynamic int8 attention), prefill a batch of prompts and
decode with greedy sampling — the Transitive-Array inference path (port of
``examples/serve_lm.py``).

The W4A8 model serves on ``int_dot``, the serving config's default
backend. The layer-level lossless check holds ``int_dot`` against the
transitive backend: on the card ``lut_cuda`` (the doubling-LUT kernel),
on the CPU ``lut`` (its plain PyTorch form), as the reference holds it
against ``lut``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.launch.specs import serve_config
from repro_torch.models.model import Model
from repro_torch.quant import QuantConfig, linear_apply, linear_init
from repro_torch.train.serve_step import greedy_generate


def main(device=None, seed: int = 0) -> dict:
    """Serve the reduced chatglm3-6b in f32 and its W4A8 twin (4 prompts
    of 16 tokens -> 8 tokens each, weights from ``Model.init(seed)``),
    then check one W4A8 linear's integer paths agree. Returns the models,
    params, batch and tokens of both runs and the two linears' outputs."""
    device = resolve_device(device)
    # FP model + its W4A8 serving twin
    cfg_fp = get_reduced("chatglm3_6b").replace(dtype=torch.float32)
    cfg_q = serve_config(cfg_fp)                  # ptq W4A8 + int8 attention

    m_fp, m_q = Model(cfg_fp, device=device), Model(cfg_q, device=device)
    params_fp = m_fp.init(seed)
    params_q = m_q.init(seed)                     # quantized at init

    rng = np.random.default_rng(seed + 1)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg_fp.vocab, size=(4, 16)))}
    out_fp = greedy_generate(m_fp, params_fp, batch, max_len=64,
                             n_steps=8).cpu()
    out_q = greedy_generate(m_q, params_q, batch, max_len=64,
                            n_steps=8).cpu()
    print("fp  tokens:", out_fp.numpy())
    print("q   tokens:", out_q.numpy())
    print("note: weights differ (fp vs freshly-quantized init); the point is "
          "the full W4A8 transitive serving path runs end-to-end.")

    # lossless check at the layer level: int paths agree bit-exactly
    transitive = "lut_cuda" if device.type == "cuda" else "lut"
    cfg = QuantConfig(mode="ptq", w_bits=4, a_bits=8, group=128)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    p = linear_init(gen, 256, 128, cfg)
    x = torch.randn((8, 256), generator=gen, device=device)
    y_dot = linear_apply(p, x, cfg.with_(backend="int_dot"))
    y_lut = linear_apply(p, x, cfg.with_(backend=transitive))
    np.testing.assert_allclose(y_dot.cpu().numpy(), y_lut.cpu().numpy(),
                               rtol=1e-5)
    print(f"TransitiveLinear int-dot == {transitive} path ✓ (lossless, "
          f"Sec. 2.1)")
    return {"model_fp": m_fp, "model_q": m_q, "params_fp": params_fp,
            "params_q": params_q, "batch": batch, "tokens_fp": out_fp,
            "tokens_q": out_q, "y_dot": y_dot, "y_lut": y_lut}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(args.device, args.seed)
