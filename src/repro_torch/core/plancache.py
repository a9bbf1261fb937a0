"""Process-level ExecutionPlan cache for the serving path (port of
``repro.core.plancache``).

The offline half (TransRow packing + Scoreboard build) must run once per
weight, not once per forward call. :class:`PlanCache` is an LRU map from
``(weight fingerprint, EngineConfig)`` to an :class:`ExecutionPlan` and
its lazily compiled device lowering (a :class:`DevicePlan`, or the
compact :class:`ForestPlan` / :class:`SparseForestPlan` of
``engine_cuda``), with hit / miss / eviction / invalidation counters (per
backend too) so a serve run can show each plan was built once.
:func:`precompile` warms it from a params tree and
:func:`attach_device_plans` embeds compiled plans next to every PTQ
weight, stacked along the stacked-block leading axes.

The cache is thread-safe the reference's way: plans build outside the
lock, and concurrent misses of one key coalesce on a ``_Pending`` slot
(one build, one miss; the other callers wait and count hits), so a replan
worker thread and the scheduling thread never build the same weight
twice. ``version=`` keys a lookup by the caller's tag instead of the
weight bytes; :meth:`PlanCache.invalidate` (by content),
:meth:`PlanCache.invalidate_version` and :meth:`PlanCache.clear`
tombstone builds still in flight so they cannot repopulate the cache.

The plan verifier (``repro_torch.analysis.planlint``) gates both halves
of a publish: a built plan is verified before it is published
(``cache-publish``; a refused build publishes nothing, its waiters retry
and a healthy rebuild counts as a miss), and a lowering before it is
memoized (``cache-lowering``; on ``engine_cuda`` the ForestPlan /
SparseForestPlan rules run there).
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Any, Hashable, Iterator

import numpy as np
import torch

from repro_torch.analysis import planlint
from repro_torch.core.backend import (EngineConfig, TransitiveBackend,
                                      get_backend)
from repro_torch.core.engine import (BatchedTransitiveEngine, DevicePlan,
                                     ExecutionPlan, ForestPlan,
                                     SparseForestPlan)

__all__ = ["PlanCache", "weight_fingerprint", "default_cache",
           "set_default_cache", "precompile", "attach_device_plans"]


@dataclasses.dataclass
class _Entry:
    """One cached weight: host plan, the content hash of the weight it was
    built from (``invalidate`` finds version-keyed entries by it) and the
    device lowerings keyed by (compile hook, device)."""
    plan: ExecutionPlan
    fingerprint: str
    device: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Pending:
    """An in-flight plan build. The first thread to miss a key builds
    outside the cache lock; concurrent lookups of the key wait on
    ``event``. ``dead`` is the invalidation tombstone: an invalidation
    that lands while the build runs marks it, and the builder then hands
    the plan to its waiters without publishing it."""
    event: threading.Event
    entry: _Entry | None = None
    error: BaseException | None = None
    dead: bool = False


def _as_numpy(qw) -> np.ndarray:
    if isinstance(qw, torch.Tensor):
        return qw.detach().cpu().numpy()
    return np.asarray(qw)


def weight_fingerprint(qw) -> str:
    """Content hash of a quantized weight (shape + dtype + bytes)."""
    a = np.ascontiguousarray(_as_numpy(qw))
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _canonical(qw) -> np.ndarray:
    """Canonical int8 values of a quantized weight for cache keying (the
    same weight as int8 or int64 must hit one key)."""
    qw = _as_numpy(qw)
    if not np.issubdtype(qw.dtype, np.integer):
        raise TypeError(f"quantized weights must be integer, got {qw.dtype}")
    if qw.dtype != np.int8:
        if qw.size and (qw.min() < -128 or qw.max() > 127):
            raise ValueError(
                "weight values outside int8 range — PlanCache covers "
                "int8-range quantized weights (w_bits <= 8)")
        qw = qw.astype(np.int8)
    return qw


def _backend_tag(backend) -> str | None:
    if backend is None:
        return None
    return backend if isinstance(backend, str) else backend.name


class PlanCache:
    """LRU cache of weight-only execution plans keyed by ``("fp", weight
    fingerprint, w_bits, T, groups)``, or ``("v", version tag, w_bits, T,
    groups)`` for lookups with ``version=``. Every operation is
    lock-protected; builds run outside the lock and coalesce per key."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._plans: OrderedDict[tuple, _Entry] = OrderedDict()
        self._pending: dict[tuple, _Pending] = {}
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._backend_stats: dict[str, dict[str, int]] = {}

    def _count(self, backend: str | None, field: str) -> None:
        """Caller holds the lock. Bumps global + per-backend counters."""
        setattr(self, field, getattr(self, field) + 1)
        if backend is not None:
            per = self._backend_stats.setdefault(
                backend, {"hits": 0, "misses": 0})
            per[field] += 1

    def _entry(self, qw, cfg: EngineConfig, version: Hashable | None,
               backend: str | None) -> _Entry:
        """The shared lookup: one hit or one miss per call. The thread
        that misses a key builds it (:meth:`_build`); threads that miss
        the same key meanwhile wait for that build and count a hit, so
        ``misses`` is the number of builds under any interleaving."""
        if version is not None:
            qw = _as_numpy(qw)          # the bytes are read on a build only
            key = ("v", version) + cfg.key()
            fp = None
        else:
            qw = _canonical(qw)
            fp = weight_fingerprint(qw)
            key = ("fp", fp) + cfg.key()
        if qw.ndim != 2:
            raise ValueError(f"qw must be 2-D (N, K), got {qw.shape}")
        while True:
            with self._lock:
                entry = self._plans.get(key)
                if entry is not None:
                    self._count(backend, "hits")
                    self._plans.move_to_end(key)
                    return entry
                pending = self._pending.get(key)
                builder = pending is None
                if builder:
                    pending = _Pending(threading.Event())
                    self._pending[key] = pending
                    self._count(backend, "misses")
            if builder:
                return self._build(pending, key, qw, cfg, fp)
            pending.event.wait()
            if pending.entry is not None:
                with self._lock:
                    self._count(backend, "hits")
                return pending.entry
            # the builder failed (its caller got the error): build anew

    def _build(self, pending: _Pending, key: tuple, qw, cfg: EngineConfig,
               fp: str | None) -> _Entry:
        """Build outside the lock, then publish unless tombstoned."""
        try:
            qw = _canonical(qw)
            plan = BatchedTransitiveEngine(bits=cfg.w_bits, t=cfg.t).plan(
                qw.astype(np.int64), groups=cfg.groups)
            # nothing malformed is published: a refusal propagates like a
            # failed build (waiters retry, nothing is cached)
            planlint.gate_plan(plan, where="cache-publish")
            entry = _Entry(plan=plan, fingerprint=fp or weight_fingerprint(qw))
        except BaseException as e:
            with self._lock:
                self._pending.pop(key, None)
            pending.error = e
            pending.event.set()
            raise
        with self._lock:
            if pending.dead:
                self.invalidations += 1     # discarded, never published
            else:
                self._plans[key] = entry
                while len(self._plans) > self.capacity:
                    self._plans.popitem(last=False)
                    self.evictions += 1
            self._pending.pop(key, None)
        pending.entry = entry
        pending.event.set()
        return entry

    def get_or_build(self, qw, cfg: EngineConfig, *,
                     version: Hashable | None = None,
                     backend=None) -> ExecutionPlan:
        """The cached plan for ``qw`` (N, K), built on a miss. With
        ``version=`` the caller's tag is the key and the weight is hashed
        only when the plan is built: bump the tag (or
        :meth:`invalidate_version`) on every weight update, since a reused
        tag returns the old plan."""
        return self._entry(qw, cfg, version, _backend_tag(backend)).plan

    def get_or_build_device(self, qw, cfg: EngineConfig, *,
                            version: Hashable | None = None, backend=None,
                            device=None
                            ) -> DevicePlan | ForestPlan | SparseForestPlan:
        """The cached plan's device lowering, compiled once per (entry,
        compile hook, device) through the requesting backend's hook
        (``engine_torch``'s when the tag names no device lowering),
        outside the lock, and verified against the plan before it is
        memoized (``cache-lowering``); a racing compile keeps the first
        result."""
        tag = _backend_tag(backend)
        entry = self._entry(qw, cfg, version, tag)
        if isinstance(backend, TransitiveBackend):
            bk = backend
        else:
            bk = get_backend(tag) if tag is not None else None
        if bk is None or not (bk.device_resident and bk.needs_plan):
            bk = get_backend("engine_torch")
        memo = (type(bk).compile, str(torch.device(device or "cpu")))
        if memo not in entry.device:
            lowered = bk.compile(entry.plan, device=device)
            planlint.gate_device(lowered, plan=entry.plan, backend=tag,
                                 where="cache-lowering")
            with self._lock:
                entry.device.setdefault(memo, lowered)
        return entry.device[memo]

    def run(self, qw, x, cfg: EngineConfig, *,
            version: Hashable | None = None, backend=None) -> np.ndarray:
        """Cached host GEMM: plan on the first sight of ``qw``, run only
        after (int64 numpy, :meth:`BatchedTransitiveEngine.run`)."""
        plan = self.get_or_build(qw, cfg, version=version, backend=backend)
        return BatchedTransitiveEngine(bits=plan.bits, t=plan.t).run(
            plan, _as_numpy(x))

    # -- invalidation -------------------------------------------------------
    def invalidate(self, qw) -> int:
        """Drop every cached plan built from this weight content (any
        bits/T/groups, version-keyed entries included). Pass the bytes the
        stale plans were built from, the *old* weights. In-flight builds
        of the same content key are tombstoned. Returns the number of
        published entries removed now."""
        fp = weight_fingerprint(_canonical(qw))
        with self._lock:
            stale = [k for k, e in self._plans.items()
                     if e.fingerprint == fp]
            for k in stale:
                del self._plans[k]
            self.invalidations += len(stale)
            for k, p in self._pending.items():
                if k[0] == "fp" and k[1] == fp:
                    p.dead = True
            return len(stale)

    def invalidate_version(self, version: Hashable) -> int:
        """Drop every version-keyed entry with this tag (any bits/T/groups)
        and tombstone its in-flight builds; returns the entries removed."""
        with self._lock:
            stale = [k for k in self._plans
                     if k[0] == "v" and k[1] == version]
            for k in stale:
                del self._plans[k]
            self.invalidations += len(stale)
            for k, p in self._pending.items():
                if k[0] == "v" and k[1] == version:
                    p.dead = True
            return len(stale)

    def clear(self) -> None:
        """Drop all entries (counted as invalidations); in-flight builds
        are tombstoned so they cannot repopulate the cache."""
        with self._lock:
            self.invalidations += len(self._plans)
            self._plans.clear()
            for p in self._pending.values():
                p.dead = True

    def reserve(self, n_plans: int) -> None:
        """Grow capacity to hold at least ``n_plans`` entries."""
        with self._lock:
            self.capacity = max(self.capacity, int(n_plans))

    def reset_stats(self) -> None:
        with self._lock:
            self.hits = self.misses = 0
            self.evictions = self.invalidations = 0
            self._backend_stats = {}

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._plans)

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "invalidations": self.invalidations,
                    "size": len(self._plans), "capacity": self.capacity,
                    "backends": {b: dict(s)
                                 for b, s in self._backend_stats.items()}}

    def __repr__(self) -> str:
        s = self.stats()
        return (f"PlanCache(size={s['size']}/{s['capacity']} "
                f"hits={s['hits']} misses={s['misses']} "
                f"evictions={s['evictions']} "
                f"invalidations={s['invalidations']})")


class _Default:
    """Holder of the process-level cache (swappable for tests)."""
    cache = PlanCache()


def default_cache() -> PlanCache:
    return _Default.cache


def set_default_cache(cache: PlanCache) -> PlanCache:
    """Swap the process-level cache; returns the previous one."""
    prev, _Default.cache = _Default.cache, cache
    return prev


def _is_ptq_layer(tree: Any) -> bool:
    return isinstance(tree, dict) and "qw" in tree and "sg" in tree


def _layer_groups(sg) -> int:
    """sg's trailing axis is the per-group scale count: 1 = per-channel."""
    return int(sg.shape[-1]) if sg.ndim else 1


def _iter_ptq_layers(tree: Any) -> Iterator[dict]:
    if _is_ptq_layer(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_ptq_layers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_ptq_layers(v)


def _plan_knobs(cfg) -> tuple[int, int]:
    """(w_bits, t) from a QuantConfig (transrow_t) or EngineConfig (t)."""
    t = getattr(cfg, "transrow_t", None)
    if t is None:
        t = cfg.t
    return int(cfg.w_bits), int(t)


def _cfg_backend(cfg, backend):
    if backend is not None:
        return get_backend(backend)
    if isinstance(getattr(cfg, "backend", None), str):
        return get_backend(cfg.backend)
    return None


def _n_plans(layers) -> int:
    return sum(int(np.prod(layer["qw"].shape[:-2], dtype=np.int64))
               for layer in layers)


def precompile(params: Any, cfg: Any, cache: PlanCache | None = None, *,
               backend=None) -> dict[str, int]:
    """Build every PTQ layer's ExecutionPlan once, ahead of serving.

    Walks ``params`` for ``{"qw", "sg"}`` layer dicts (including weights
    stacked along leading axes) and warms ``cache``. Returns
    ``{"layers", "plans", "built"}`` like the reference."""
    cache = default_cache() if cache is None else cache
    b = _cfg_backend(cfg, backend)
    tag = b.name if b is not None else None
    w_bits, t = _plan_knobs(cfg)
    misses0 = cache.stats()["misses"]
    layers = list(_iter_ptq_layers(params))
    cache.reserve(_n_plans(layers))
    n_plans = 0
    for layer in layers:
        qw = _as_numpy(layer["qw"])
        ecfg = EngineConfig(w_bits=w_bits, t=t,
                            groups=_layer_groups(layer["sg"]))
        for idx in np.ndindex(*qw.shape[:-2]):
            cache.get_or_build(qw[idx], ecfg, backend=tag)
            n_plans += 1
    return {"layers": len(layers), "plans": n_plans,
            "built": cache.stats()["misses"] - misses0}


def attach_device_plans(params: Any, cfg: Any,
                        cache: PlanCache | None = None, *,
                        backend=None) -> Any:
    """Return a copy of ``params`` with a compiled ``"dplan"`` per PTQ layer.

    The plan is the backend's lowering: a :class:`DevicePlan` for
    ``engine_torch``, a compact :class:`ForestPlan` for ``engine_cuda``
    (a :class:`SparseForestPlan` from T = 16; packed here, once; the dense
    plan reaches the card only where a sparse table does not fit shared
    memory). Stacked
    weights get one plan per slice, stacked along the same leading axes
    (DevicePlans padded to a shared direct bound first); plans are placed
    on the weight's device. The tensors themselves are shared with
    ``params``, not copied. An embedded plan is only as fresh as this call:
    re-attach after any weight update."""
    cache = default_cache() if cache is None else cache
    b = _cfg_backend(cfg, backend)
    if b is None:
        b = get_backend("engine_torch")
    if not (b.needs_plan and b.device_resident):
        raise ValueError(
            f"backend '{b.name}' does not execute from device plans; "
            f"attach_device_plans serves device-resident planned backends "
            f"(engine_torch, engine_cuda)")
    w_bits, t = _plan_knobs(cfg)
    cache.reserve(_n_plans(_iter_ptq_layers(params)))

    def walk(tree: Any) -> Any:
        if isinstance(tree, dict):
            if _is_ptq_layer(tree):
                qw = _as_numpy(tree["qw"])
                device = tree["qw"].device
                ecfg = EngineConfig(w_bits=w_bits, t=t,
                                    groups=_layer_groups(tree["sg"]))
                lead = qw.shape[:-2]
                if lead:
                    plans = [cache.get_or_build(qw[idx], ecfg,
                                                backend=b.name)
                             for idx in np.ndindex(*lead)]
                    flat = b.compile(plans, device=device)
                    dplan = dataclasses.replace(flat, **{
                        f: a.reshape(lead + a.shape[1:])
                        for f, a in flat.leaves().items()})
                else:
                    dplan = cache.get_or_build_device(
                        qw, ecfg, backend=b.name, device=device)
                return {**tree, "dplan": dplan}
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        if isinstance(tree, tuple):
            return tuple(walk(v) for v in tree)
        return tree

    return walk(params)
