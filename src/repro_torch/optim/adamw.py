"""AdamW with global-norm clipping and low-precision moments (port of
``repro.optim.adamw``).

The reference's arithmetic, leaf by leaf in float32: the gradients are
clipped by their global norm (computed in f32), the bias corrections are
``1 - b ** count`` in f32, weight decay applies to every leaf (norms and
embeddings included), the moments are stored in ``moment_dtype`` and,
with ``factored_v``, the second moment of a leaf of ndim >= 2 as
Adafactor-style row and column statistics (``{"r", "c"}``, f32). New
params are cast back to each leaf's dtype.

Params, gradients and moments are nested dicts of tensors laid out alike.
:meth:`AdamW.update` writes the new params and moments into the given
tensors in place (under ``torch.no_grad``) and returns them.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["AdamW", "OptState", "global_norm", "leaves", "unflatten",
           "tree_map"]

OptState = dict[str, Any]


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order (the order of the
    reference's pytree leaves)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def unflatten(tree, flat) -> dict:
    """The tensors of ``flat`` (in :func:`leaves` order) laid out like
    ``tree``."""
    it = iter(flat)

    def one(t):
        if isinstance(t, dict):
            return {k: one(t[k]) for k in sorted(t)}
        return next(it)
    return one(tree)


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """AdamW; ``factored_v=True`` stores the second moment as
    Adafactor-style row/col statistics for ndim >= 2 leaves (O(n+m)
    instead of O(n*m))."""
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32
    factored_v: bool = False

    def _v_init(self, p):
        if self.factored_v and p.ndim >= 2:
            return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                     device=p.device),
                    "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                     dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)

    def init(self, params) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)
        dev = leaves(params)[0].device
        return {"m": tree_map(zeros, params),
                "v": tree_map(self._v_init, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    @torch.no_grad()
    def update(self, grads, state: OptState, params, lr, gnorm=None):
        """One step: returns (params, state), both updated in place.
        ``gnorm``: the gradients' :func:`global_norm` where the caller has
        it already (else computed here)."""
        count = state["count"] + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        c1 = 1.0 - self.b1 ** count.to(torch.float32)
        c2 = 1.0 - self.b2 ** count.to(torch.float32)
        lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m32 = self.b1 * m.to(torch.float32)
            m32 += (1 - self.b1) * g
            if isinstance(v, dict):                       # factored second
                gg = g * g
                r = self.b2 * v["r"] + (1 - self.b2) * torch.mean(gg, -1)
                c = self.b2 * v["c"] + (1 - self.b2) * torch.mean(gg, -2)
                del gg
                vhat = (r[..., None] * c[..., None, :]
                        / torch.clamp(torch.mean(r, -1)[..., None, None],
                                      min=1e-30))
                v["r"].copy_(r)
                v["c"].copy_(c)
            else:
                vhat = self.b2 * v.to(torch.float32)
                vhat += (1 - self.b2) * g * g
                v.copy_(vhat)
            del g
            m.copy_(m32)
            step = m32.div_(c1)
            step /= torch.sqrt(vhat.div_(c2)).add_(self.eps)
            step += self.weight_decay * p.to(torch.float32)
            new_p = p.to(torch.float32) - lr * step
            p.copy_(new_p)

        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state["m"]), _v_leaves(state["v"],
                                                            params)):
            upd(p, g, m, v)
        state["count"] = count
        return params, state


def _v_leaves(v, params) -> list:
    """The second moments in the order of ``leaves(params)``, a factored
    one (``{"r", "c"}``) kept whole."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _v_leaves(v[k], params[k])]
    return [v]
