"""Weight carry-over from the JAX reference to the port.

:func:`params_from_reference` turns the reference's params — a nested
dict whose leaves are numpy arrays (``np.asarray`` of each JAX leaf) — into
the port's params with the same keys and the same stacked-block layout, so
both packages compute the same thing from the same weights. It takes
numpy only: the port never sees JAX. bfloat16 leaves (numpy's
``bfloat16`` extension dtype) are carried bit for bit.

A reference ``DevicePlan`` riding in the params (any object with the plan
leaf attributes) becomes the port's :class:`DevicePlan`, checked for tile
locality once here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import (DEVICE_DATA_FIELDS, DevicePlan,
                                     check_tile_local)

__all__ = ["tensor_from_numpy", "params_from_reference"]


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """One numpy array (bfloat16 included) as a torch tensor on ``device``."""
    a = np.require(np.asarray(a), requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _plan_from_reference(p, device) -> DevicePlan:
    leaves = {f: np.asarray(getattr(p, f)) for f in DEVICE_DATA_FIELDS}
    local = check_tile_local(p.t, p.k, leaves["level_src"],
                             leaves["level_xsrc"], leaves["direct_idx"],
                             leaves["direct_x_idx"], leaves["gather_idx"])
    return DevicePlan(t=int(p.t), bits=int(p.bits), n=int(p.n), k=int(p.k),
                      groups=int(p.groups), tile_local=local,
                      **{f: tensor_from_numpy(a, device)
                         for f, a in leaves.items()})


def params_from_reference(tree: Any, device=None) -> Any:
    """The reference params tree as the port's params on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    if all(hasattr(tree, f) for f in DEVICE_DATA_FIELDS):
        return _plan_from_reference(tree, device)
    return tensor_from_numpy(tree, device)
