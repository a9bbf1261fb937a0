"""Hold the port's W4A8 ``int_dot`` serve path to the reference on shared
activation codes (the method of ``tests/test_torch_recurrent.py``).

Every per-token quantization moves a code by one step now and then where
two float paths part by an ulp (XLA's fusions part the reference's own
jitted run from its eager one the same way), and a recurrence or a
softmax carries that step on. So the reference runs eagerly with its
per-token quantizer recorded, and at each quantization the port computes
its own codes and scales, which must agree (codes within one step, at
most 1e-4 of them off; scales within rtol 1e-4), then carries on with
the reference's. On those codes every step's logits and greedy token are
compared.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.quant.quantize as RQ
from repro.models import attention as RA
import repro_torch.quant.quantize as PQ
from repro_torch.models import attention as PA


def greedy_on_shared_codes(ref_model, raw, model, params, batch, max_len,
                           gen, monkeypatch):
    """Greedy-decode ``batch`` (numpy ``tokens`` and, where the config has
    one, ``context``) for ``gen`` tokens in both packages, the port on the
    reference's codes. Returns ([(port logits, port token)], [reference
    logits], [reference tokens], number of quantizations); the codes'
    agreement is asserted on the way."""
    toks = batch["tokens"]
    s = toks.shape[1]
    ref_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    codes, want_logits, want_toks = [], [], []
    ref_quantize = RQ.quantize_per_token

    def record(x, bits=8):
        q, scale = ref_quantize(x, bits)
        codes.append((np.asarray(q), np.asarray(scale)))
        return q, scale
    monkeypatch.setattr(RQ, "quantize_per_token", record)
    monkeypatch.setattr(RA, "quantize_per_token", record)
    with jax.disable_jit():
        logits, caches = ref_model.prefill(raw, ref_batch, max_len)
        for i in range(gen):
            want_logits.append(np.asarray(logits))
            want_toks.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
            if i + 1 < gen:
                logits, caches = ref_model.decode_step(
                    raw, caches, jnp.asarray(want_toks[-1][:, None],
                                             jnp.int32), jnp.int32(s + i))
    monkeypatch.undo()

    port_quantize = PQ.quantize_per_token
    seen = {"calls": 0, "off": 0, "codes": 0}

    def shared(x, bits=8):
        q, scale = port_quantize(x, bits)
        rq, rs = codes[seen["calls"]]
        seen["calls"] += 1
        assert tuple(q.shape) == rq.shape and tuple(scale.shape) == rs.shape
        off = np.abs(q.numpy().astype(np.int64) - rq.astype(np.int64))
        assert off.max() <= 1
        seen["off"] += int((off > 0).sum())
        seen["codes"] += off.size
        np.testing.assert_allclose(scale.float().numpy(), rs, rtol=1e-4,
                                   atol=0)
        return torch.from_numpy(rq.copy()), torch.from_numpy(
            rs.copy()).to(scale.dtype)
    monkeypatch.setattr(PQ, "quantize_per_token", shared)
    monkeypatch.setattr(PA, "quantize_per_token", shared)
    port_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, caches = model.prefill(params, port_batch, max_len)
    got = []
    for i in range(gen):
        tok = torch.argmax(logits[:, -1], -1)
        got.append((logits, tok))
        if i + 1 < gen:
            logits, caches = model.decode_step(params, caches, tok[:, None],
                                               s + i)
    monkeypatch.undo()
    assert seen["calls"] == len(codes) > 0
    assert seen["off"] <= 1e-4 * seen["codes"], seen
    return got, want_logits, want_toks, len(codes)
