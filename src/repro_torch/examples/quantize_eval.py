"""Accuracy pipeline (port of ``examples/quantize_eval.py``; the paper's
Tbl. 3 stand-in, no LLaMA weights offline): train a tiny LM, then
evaluate perplexity under FP32, W8A8 and W4A8 TransitiveLinear serving —
the paper's lossless-vs-quantizer separation: transitive execution adds
ZERO error on top of the quantizer.

The integer GEMM of ``int_dot`` and the transitive backends give the same
int32 accumulators, so their perplexities are equal. On the card the
transitive backends are ``lut_cuda`` (the doubling-LUT kernel, B3) and
``engine_cuda`` (the forest kernel, B1, from plans built on the host); on
the CPU, ``lut`` (the reference's transitive backend).

  PYTHONPATH=src python -m repro_torch.examples.quantize_eval [--device cpu]
"""
import argparse
import math

import torch

from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.quant import QuantConfig, quantize_groupwise
from repro_torch.train.loop import train


def quantize_params(params, w_bits, group=64):
    """PTQ: fp linear weights -> (qw, sg) leaves for mode='ptq' serving."""
    def q(tree):
        if isinstance(tree, dict) and "w" in tree and tree["w"].ndim >= 2:
            w = tree["w"].detach()
            flat = w.reshape(-1, w.shape[-1])
            qw, sg = quantize_groupwise(flat, w_bits, min(group,
                                                          w.shape[-1]))
            return {"qw": qw.reshape(w.shape),
                    "sg": sg.reshape(w.shape[:-1] + (-1,))}
        if isinstance(tree, dict):
            return {k: q(v) for k, v in tree.items()}
        return tree
    return q(params)


def evaluate(device=None, steps: int = 60, log=print) -> dict:
    """Train reduced smollm (2 f32 layers, seq 64, batch 16, ``steps``
    steps at lr 5e-3), then the perplexity of one held-out batch under
    fp32, and W8A8 and W4A8 (group 64) on ``int_dot`` and each transitive
    backend. Returns {"hist": the training history, "fp32": ppl,
    "W8A8": {backend: ppl}, "W4A8": {...}}."""
    device = resolve_device(device)
    cfg = get_reduced("smollm_135m").replace(n_layers=2,
                                             dtype=torch.float32)
    state, hist = train(cfg, seq_len=64, global_batch=16, steps=steps,
                        lr=5e-3, device=device)
    params = state["params"]
    log(f"trained: loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")

    data = SyntheticLM(cfg, 64, 16, seed=123, device=device)
    batch = {k: v[0] for k, v in data.batch(999).items()}

    def ppl(model, p):
        with torch.no_grad():
            return math.exp(float(model.loss(p, batch)))

    out = {"hist": hist, "fp32": ppl(Model(cfg, device=device), params)}
    log(f"PPL fp32 : {out['fp32']:8.3f}")
    for bits in (8, 4):
        qcfg = cfg.replace(quant=QuantConfig(mode="ptq", w_bits=bits,
                                             a_bits=8, group=64))
        qp = quantize_params(params, bits)
        qp = {**params, **{k: qp[k] for k in ("blocks",)}}
        res = {"int_dot": ppl(Model(qcfg, device=device), qp)}
        transitive = ("lut_cuda", "engine_cuda") if device.type == "cuda" \
            else ("lut",)
        for backend in transitive:
            res[backend] = ppl(Model(qcfg.replace(
                quant=qcfg.quant.with_(backend=backend)), device=device), qp)
        out[f"W{bits}A8"] = res
        others = ", ".join(f"{b} {p:8.3f}" for b, p in res.items()
                           if b != "int_dot")
        log(f"PPL W{bits}A8 : {res['int_dot']:8.3f}   (transitive: "
            f"{others} — identical => lossless)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    return evaluate(args.device, args.steps)


if __name__ == "__main__":
    main()
