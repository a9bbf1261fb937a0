"""Plan-bundle distribution: plan once, serve everywhere (port of
``repro.fleet.bundles``).

  * The **planner** role walks the params once, builds every PTQ layer's
    plan and writes one ``.npz`` per weight slice
    (:meth:`ExecutionPlan.save` with its DevicePlan lowering, the
    reference's keys) and a ``manifest.json`` (written last) with the
    whole model's weight fingerprint, the ``EngineConfig`` knobs, the
    backend name and each file's SHA-256 (:func:`write_bundles`).
  * A **server** attaches the bundles instead of planning
    (:func:`load_bundles`): zero plan builds. The manifest's fingerprint,
    config and backend are checked against the server's own weights and
    config, every file's hash is checked, and each slice checks its own
    stored fingerprint (``ExecutionPlan.load_bundle(qw=...)``).

Bundles carry DevicePlans, as the reference's do. ``engine_torch``
attaches them as they are; ``engine_cuda`` packs them into its kernels'
ForestPlans / SparseForestPlans (``EngineCudaBackend.lower``: packing is
not planning, and the plan cache is not touched). The loader reads the
reference's backend names as the port's (``engine_jit`` is
``engine_torch``, ``engine_pallas`` is ``engine_cuda``), so a bundle
directory the reference's ``write_bundles`` wrote serves here with zero
builds. The plan verifier (``repro_torch.analysis.planlint``) gates the
load (``bundle-load``): the manifest's structure before any mismatch
check, every file's structure before its SHA-256, and every attached,
lowered plan.

``force=True`` skips the fingerprint and config refusals; a damaged file
(hash mismatch) and a shape that cannot run are refused all the same.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch.analysis import planlint
from repro_torch.core.backend import EngineConfig, get_backend
from repro_torch.core.engine import (DEVICE_DATA_FIELDS, BundleMismatchError,
                                     DevicePlan, ExecutionPlan, compile_plan)
from repro_torch.core.plancache import (_as_numpy, _canonical, _cfg_backend,
                                        _is_ptq_layer, _layer_groups,
                                        _plan_knobs, default_cache,
                                        weight_fingerprint)
from repro_torch.fleet.replan import fingerprint_params

__all__ = ["MANIFEST", "load_bundles", "read_manifest", "write_bundles"]

MANIFEST = "manifest.json"
_FORMAT = 1
# the reference's backend names for the port's planned device backends
REFERENCE_NAMES = {"engine_jit": "engine_torch",
                   "engine_pallas": "engine_cuda"}


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _iter_layer_paths(tree: Any, path: tuple = ()):
    """``("a/b/c", layer_dict)`` for every PTQ layer: the key both sides
    store and look a layer up by."""
    if isinstance(tree, dict):
        if _is_ptq_layer(tree):
            yield "/".join(map(str, path)), tree
            return
        for k, v in tree.items():
            yield from _iter_layer_paths(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _iter_layer_paths(v, path + (i,))


def _planned_backend(cfg, backend):
    b = _cfg_backend(cfg, backend)
    if b is None:
        b = get_backend("engine_torch")
    if not (b.needs_plan and b.device_resident):
        raise ValueError(
            f"backend '{b.name}' does not execute from device plans; "
            f"plan bundles distribute the planned device backends")
    return b


def write_bundles(params: Any, cfg: Any, out_dir, *, backend=None,
                  cache=None) -> dict:
    """Planner role: plan every PTQ layer, write the bundles to
    ``out_dir`` and return the manifest (also written as manifest.json,
    last).

    ``cfg`` names the serving quantization (a ``QuantConfig`` or an
    ``EngineConfig``); ``backend=`` overrides the backend the manifest
    names (default: the one ``cfg`` names, else ``engine_torch``). Plans
    build through ``cache`` (default: the process cache). Stacked layers
    write one file per slice, all padded to the layer's shared direct
    width, so the loader stacks them as they are."""
    cache = default_cache() if cache is None else cache
    b = _planned_backend(cfg, backend)
    w_bits, t = _plan_knobs(cfg)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    layers: dict[str, dict] = {}
    n_files = 0
    for lpath, layer in _iter_layer_paths(params):
        qw = _as_numpy(layer["qw"])
        ecfg = EngineConfig(w_bits=w_bits, t=t,
                            groups=_layer_groups(layer["sg"]))
        lead = qw.shape[:-2]
        idxs = list(np.ndindex(*lead)) if lead else [()]
        plans = [cache.get_or_build(qw[i] if i else qw, ecfg,
                                    backend=b.name) for i in idxs]
        d = max(max(p.direct_tile.size for p in plans), 1)
        entries = []
        safe = lpath.replace("/", "__")
        for i, plan in zip(idxs, plans):
            fp = weight_fingerprint(_canonical(qw[i] if i else qw))
            fname = (f"{safe}__{'_'.join(map(str, i))}.npz" if i
                     else f"{safe}.npz")
            fpath = os.path.join(out_dir, fname)
            plan.save(fpath, device=compile_plan(plan, direct_pad=d),
                      backend=b.name, fingerprint=fp)
            entries.append({"file": fname, "index": list(i),
                            "fingerprint": fp, "sha256": _sha256(fpath)})
            n_files += 1
        layers[lpath] = {"lead": list(lead), "groups": ecfg.groups,
                         "direct_pad": d, "files": entries}
    manifest = {"format": _FORMAT, "backend": b.name,
                "engine_config": {"w_bits": w_bits, "t": t},
                "weights_fingerprint": fingerprint_params(params),
                "n_layers": len(layers), "n_files": n_files,
                "layers": layers,
                "plan_wall_s": time.perf_counter() - t0}
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def read_manifest(bundle_dir) -> dict:
    path = os.path.join(bundle_dir, MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no {MANIFEST} in {bundle_dir} — not a plan-bundle "
            f"directory (write one with the planner role)")
    with open(path) as f:
        return json.load(f)


def _stack(devices: list[DevicePlan], lead: tuple) -> DevicePlan:
    """One DevicePlan with the slices stacked along ``lead``."""
    if not lead:
        return devices[0]
    stacked = {f: torch.stack([getattr(d, f) for d in devices]).reshape(
        lead + tuple(getattr(devices[0], f).shape))
        for f in DEVICE_DATA_FIELDS}
    return dataclasses.replace(
        devices[0], **stacked,
        tile_local=all(d.tile_local for d in devices))


def load_bundles(params: Any, cfg: Any, bundle_dir, *,
                 force: bool = False) -> Any:
    """Server role: a copy of ``params`` with each PTQ layer's plan
    attached from ``bundle_dir`` (as ``attach_device_plans`` attaches
    them: stacked like the weights, on the weights' device), with zero
    plan builds and no plan-cache lookup.

    Checked before any plan is trusted, in the reference's order:

      1. the manifest: its structure (the ``bundle-load`` gate,
         ``planlint.PlanVerificationError``), then its format, backend
         and engine config against the serving ``cfg``, and its weight
         fingerprint against ``params`` (:class:`BundleMismatchError`;
         ``force=True`` skips these);
      2. per layer: the manifest covers it, with its stacked axes; per
         file: its structure (the gate: a truncated or malformed file is
         refused before it is hashed), its SHA-256 (damage refuses even
         with ``force``), then ``ExecutionPlan.load_bundle(qw=slice,
         cfg=...)`` (config, shape (even with ``force``), slice
         fingerprint);
      3. the attached, lowered plan: the gate again (the forest rules on
         ``engine_cuda``'s ForestPlans; with ``REPRO_PLANLINT=0`` the
         rules that guard a kernel's raw-pointer reads still run).

    A manifest that names layers ``params`` does not hold refuses unless
    ``force``."""
    manifest = read_manifest(bundle_dir)
    b = _planned_backend(cfg, None)
    # structure before any semantic check: a malformed manifest never
    # reaches the mismatch logic below
    planlint.gate_manifest(manifest, where="bundle-load",
                           bundle_dir=bundle_dir, backend=b.name)
    w_bits, t = _plan_knobs(cfg)
    mcfg = manifest.get("engine_config", {})
    if not force:
        if manifest.get("format") != _FORMAT:
            raise BundleMismatchError(
                f"{bundle_dir}: manifest format "
                f"{manifest.get('format')} != {_FORMAT}")
        named = manifest.get("backend")
        if REFERENCE_NAMES.get(named, named) != b.name:
            raise BundleMismatchError(
                f"{bundle_dir}: bundles were compiled for backend "
                f"'{named}', this cell serves '{b.name}' (plan lowerings "
                f"are backend-tagged); pass force=True to attach anyway")
        if (mcfg.get("w_bits"), mcfg.get("t")) != (w_bits, t):
            raise BundleMismatchError(
                f"{bundle_dir}: bundle engine_config {mcfg} does not "
                f"match serving (w_bits={w_bits}, t={t})")
        fp = fingerprint_params(params)
        want = manifest.get("weights_fingerprint")
        if fp != want:
            raise BundleMismatchError(
                f"{bundle_dir}: bundles were planned from weights "
                f"{want}, this cell holds {fp} — a stale bundle would "
                f"serve the old weights' GEMM; re-plan (planner role) "
                f"or pass force=True")
    layers = dict(manifest["layers"])

    def attach(lpath: str, layer: dict) -> dict:
        meta = layers.pop(lpath, None)
        if meta is None:
            raise BundleMismatchError(
                f"{bundle_dir}: no bundle for layer '{lpath}' — the "
                f"manifest covers a different model")
        qw = _as_numpy(layer["qw"])
        lead = qw.shape[:-2]
        if list(lead) != list(meta["lead"]):
            raise BundleMismatchError(
                f"{bundle_dir}: layer '{lpath}' lead axes {lead} != "
                f"manifest {meta['lead']}")
        ecfg = EngineConfig(w_bits=w_bits, t=t, groups=int(meta["groups"]))
        devices, plans = [], []
        for e in meta["files"]:
            fpath = os.path.join(bundle_dir, e["file"])
            # structure first: a truncated or corrupt npz is refused
            # before its hash is computed
            planlint.gate_bundle_file(fpath, where="bundle-load",
                                      backend=b.name)
            if _sha256(fpath) != e["sha256"]:
                raise BundleMismatchError(
                    f"{fpath}: file hash mismatch — bundle corrupted "
                    f"or tampered (force= does not bypass this)")
            i = tuple(e["index"])
            bundle = ExecutionPlan.load_bundle(
                fpath, qw=(qw[i] if i else qw), cfg=ecfg, force=force)
            devices.append(bundle.device if bundle.device is not None
                           else compile_plan(bundle.plan))   # plan-only file
            plans.append(bundle.plan)
        dplan = _stack(devices, lead)
        device = layer["qw"].device
        lower = getattr(b, "lower", None)       # engine_cuda packs
        if lower is not None:
            dplan = lower(dplan, device)
        else:
            dplan = dataclasses.replace(dplan, **{
                f: a.to(device) for f, a in dplan.leaves().items()})
        planlint.gate_device(dplan, plan=None if lead else plans[0],
                             where="bundle-load", backend=b.name,
                             guard_kernel=True)
        return {**layer, "dplan": dplan}

    def walk(tree: Any, path: tuple = ()):
        if isinstance(tree, dict):
            if _is_ptq_layer(tree):
                return attach("/".join(map(str, path)), tree)
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        if isinstance(tree, tuple):
            return tuple(walk(v, path + (i,)) for i, v in enumerate(tree))
        return tree

    out = walk(params)
    if layers and not force:
        raise BundleMismatchError(
            f"{bundle_dir}: manifest carries bundles for layers not in "
            f"these params: {sorted(layers)}")
    return out
