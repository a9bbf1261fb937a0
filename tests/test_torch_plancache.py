"""Port parity: the plan cache's coalescing and mutation API
(``repro_torch.core.plancache``) against ``repro.core.plancache``.

* Concurrent misses of one key build once (one miss; the other lookups
  wait on the build and count hits), a failed build releases its waiters,
  and a cold build does not block other keys.
* ``invalidate`` (by content, version-keyed entries too),
  ``invalidate_version``, ``clear`` (a tombstone: a build in flight is
  handed to its callers but never published), ``reset_stats``,
  ``__len__``, ``run``.
* The same sequence of calls leaves the same counters as the reference's
  ``PlanCache``.

Threads are held at their races by events with timeouts, never by sleeps.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_threads import one_torch_thread  # noqa: E402,F401
import repro.core.plancache as RC  # noqa: E402
from repro.core.backend import EngineConfig as RefEngineConfig  # noqa: E402
import repro_torch.core.plancache as PC  # noqa: E402
from repro_torch.core.backend import EngineConfig  # noqa: E402
from repro_torch.core.engine import (BatchedTransitiveEngine,  # noqa: E402
                                     ForestPlan, run_device)

CFG = EngineConfig(w_bits=4, t=8, groups=1)


def _w(rng, n=9, k=32):
    return rng.integers(-8, 8, size=(n, k))


def _run_threads(fns, timeout=60):
    """Run callables concurrently; re-raise the first worker exception."""
    errs = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:   # noqa: BLE001 — reported below
                errs.append(e)
        return run
    ts = [threading.Thread(target=wrap(fn)) for fn in fns]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in ts), "a thread hung"
    if errs:
        raise errs[0]


def _gate_builds(monkeypatch, gate, entered, only=None):
    """Park every plan build (or those of weight ``only``) until ``gate``
    opens, setting ``entered`` first; returns the list of building
    threads' names."""
    real = BatchedTransitiveEngine.plan
    builders = []

    def gated(self, w, groups=1):
        builders.append(threading.current_thread().name)
        if only is None or np.array_equal(w, only):
            entered.set()
            assert gate.wait(timeout=60), "test gate never opened"
        return real(self, w, groups=groups)
    monkeypatch.setattr(BatchedTransitiveEngine, "plan", gated)
    return builders


class _CountingEvent(threading.Event):
    """An Event that counts the threads parked in ``wait``."""

    def __init__(self):
        super().__init__()
        self.parked = 0
        self.cond = threading.Condition()

    def wait(self, timeout=None):
        with self.cond:
            self.parked += 1
            self.cond.notify_all()
        return super().wait(timeout)


@pytest.mark.parametrize("n_threads", [2, 8])
def test_concurrent_misses_build_once(rng, monkeypatch, n_threads):
    """The first thread to miss builds; the others, arriving while it
    builds, wait on it: one build, one miss, the rest hits, one entry,
    every thread the same plan."""
    gate, entered = threading.Event(), threading.Event()
    builders = _gate_builds(monkeypatch, gate, entered)
    events = []
    real_pending = PC._Pending

    def pending(_event):
        events.append(_CountingEvent())
        return real_pending(events[-1])
    monkeypatch.setattr(PC, "_Pending", pending)
    c = PC.PlanCache()
    w = _w(rng)
    got = [None] * n_threads

    def first():
        got[0] = c.get_or_build(w, CFG)

    def later(i):
        def run():
            assert entered.wait(timeout=60)
            got[i] = c.get_or_build(w, CFG)
        return run

    def opener():
        # open the gate once every later thread waits on the build
        assert entered.wait(timeout=60)
        ev = events[0]
        with ev.cond:
            assert ev.cond.wait_for(lambda: ev.parked == n_threads - 1,
                                    timeout=60)
        gate.set()
    _run_threads([first, opener] + [later(i) for i in range(1, n_threads)])
    assert len(builders) == 1 and len(events) == 1
    assert all(p is got[0] and p is not None for p in got)
    s = c.stats()
    assert (s["misses"], s["hits"], len(c)) == (1, n_threads - 1, 1)


def test_builder_failure_releases_waiters(rng, monkeypatch):
    """A failed build hands its error to its own caller only; a waiter
    retries, builds, and the entry lands (two misses: two builds)."""
    first_inside, waiter_parked = threading.Event(), threading.Event()
    real = BatchedTransitiveEngine.plan
    armed = {"fail": True}

    def flaky(self, w, groups=1):
        if armed.pop("fail", False):
            first_inside.set()
            assert waiter_parked.wait(timeout=60)
            raise RuntimeError("simulated plan-build failure")
        return real(self, w, groups=groups)
    monkeypatch.setattr(BatchedTransitiveEngine, "plan", flaky)
    c = PC.PlanCache()
    w = _w(rng)
    out = {}

    def first():
        with pytest.raises(RuntimeError, match="simulated"):
            c.get_or_build(w, CFG)

    def second():
        assert first_inside.wait(timeout=60)
        waiter_parked.set()
        out["plan"] = c.get_or_build(w, CFG)
    _run_threads([first, second])
    assert out["plan"] is not None and len(c) == 1
    assert c.stats()["misses"] == 2 and c.stats()["hits"] == 0
    assert c.get_or_build(w, CFG) is out["plan"]


def test_cold_build_does_not_block_other_keys(rng, monkeypatch):
    """While one thread is inside a cold build, another key's lookup
    completes: builds run outside the lock."""
    gate, entered = threading.Event(), threading.Event()
    w_slow, w_fast = _w(rng), _w(rng)
    _gate_builds(monkeypatch, gate, entered, only=w_slow)
    c = PC.PlanCache()
    t = threading.Thread(target=lambda: c.get_or_build(w_slow, CFG))
    t.start()
    try:
        assert entered.wait(timeout=60)
        c.get_or_build(w_fast, CFG)
        assert c.stats()["misses"] == 2 and len(c) == 1
    finally:
        gate.set()
        t.join(timeout=60)
    assert not t.is_alive() and len(c) == 2


@pytest.mark.parametrize("how", ["invalidate", "invalidate_version",
                                 "clear"])
def test_invalidation_during_build_is_not_published(rng, monkeypatch, how):
    """The tombstone: an invalidation landing while the weight's plan is
    still building cannot remove an unpublished entry, so it marks the
    build; its caller still gets the plan, the cache stays empty, the
    discard counts as an invalidation, and the next lookup builds anew."""
    gate, entered = threading.Event(), threading.Event()
    _gate_builds(monkeypatch, gate, entered)
    c = PC.PlanCache()
    w = _w(rng)
    version = "layer0" if how == "invalidate_version" else None
    got = {}
    t = threading.Thread(target=lambda: got.update(
        plan=c.get_or_build(w, CFG, version=version)))
    t.start()
    try:
        assert entered.wait(timeout=60)
        if how == "invalidate":
            assert c.invalidate(w) == 0         # nothing published yet
        elif how == "invalidate_version":
            assert c.invalidate_version("layer0") == 0
        else:
            c.clear()
    finally:
        gate.set()
        t.join(timeout=60)
    assert not t.is_alive()
    assert got["plan"] is not None
    assert len(c) == 0 and c.stats()["invalidations"] == 1
    fresh = c.get_or_build(w, CFG, version=version)
    assert fresh is not got["plan"] and len(c) == 1
    assert c.stats()["misses"] == 2


def test_invalidate_by_content_finds_version_keyed_entries(rng):
    c = PC.PlanCache()
    w = _w(rng)
    c.get_or_build(w, CFG, version=("l", 0))
    c.get_or_build(w, CFG)                           # content-keyed twin
    c.get_or_build(_w(rng), CFG, version=("m", 0))   # another weight
    assert c.invalidate(w.astype(np.int64)) == 2     # any dtype, one key
    assert len(c) == 1 and c.stats()["invalidations"] == 2


def test_invalidate_version_covers_in_place_update(rng):
    """A reused tag over new bytes returns the old plan until the tag is
    invalidated (the new bytes cannot find it by content)."""
    c = PC.PlanCache()
    w_old = _w(rng)
    stale = c.get_or_build(w_old, CFG, version="layer0")
    w_new = w_old.copy()
    w_new[0, 0] ^= 1
    assert c.invalidate(w_new) == 0
    assert c.get_or_build(w_new, CFG, version="layer0") is stale
    assert c.invalidate_version("layer0") == 1
    fresh = c.get_or_build(w_new, CFG, version="layer0")
    assert fresh is not stale and c.stats()["misses"] == 2
    assert c.get_or_build(w_new, CFG, version=("layer0", 1)) is not stale


def test_version_lookups_hash_only_on_build(rng, monkeypatch):
    calls = []
    real = PC.weight_fingerprint
    monkeypatch.setattr(PC, "weight_fingerprint",
                        lambda qw: calls.append(1) or real(qw))
    c = PC.PlanCache()
    w = _w(rng)
    for _ in range(4):
        c.get_or_build(w, CFG, version=("layer0", 0))
    assert len(calls) == 1
    c.get_or_build(w, CFG)
    assert len(calls) == 2


def test_clear_reset_stats_len_and_run(rng):
    c = PC.PlanCache()
    ws = [_w(rng) for _ in range(3)]
    for w in ws:
        c.get_or_build(w, CFG)
    assert len(c) == 3
    x = rng.integers(-128, 128, size=(32, 5))
    for w in ws:                                     # hits, host run exact
        np.testing.assert_array_equal(c.run(w, x, CFG), w @ x)
    c.clear()
    assert len(c) == 0 and c.stats()["invalidations"] == 3
    c.reset_stats()
    s = c.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["invalidations"]) \
        == (0, 0, 0, 0) and s["backends"] == {}


@pytest.mark.parametrize("backend", ["engine_torch", "engine_cuda"])
def test_device_lowering_is_memoised_per_entry(rng, backend):
    c = PC.PlanCache()
    w = _w(rng, n=16, k=64)
    d1 = c.get_or_build_device(w, CFG, backend=backend)
    assert c.get_or_build_device(w, CFG, backend=backend) is d1
    assert c.stats()["misses"] == 1 and c.stats()["hits"] == 1
    assert isinstance(d1, ForestPlan) == (backend == "engine_cuda")
    if backend == "engine_torch":
        x = torch.from_numpy(rng.integers(-128, 128, size=(64, 3)))
        assert torch.equal(run_device(d1, x).long(),
                           torch.from_numpy(w) @ x)


# the reference's backend names for the port's
_REF_NAME = {"engine_torch": "engine_jit", "engine_cuda": "engine_pallas",
             None: None}


def _sequence(mod, cfg, ws, x, backend_names):
    """One sequence of calls on ``mod.PlanCache`` (``cfg``: that package's
    EngineConfig); returns its stats."""
    c = mod.PlanCache(capacity=3)
    name = backend_names
    c.get_or_build(ws[0], cfg(4, 8), backend=name["engine_torch"])
    c.get_or_build(ws[0], cfg(4, 8), backend=name["engine_torch"])
    c.get_or_build(ws[1].astype(np.int64), cfg(4, 8))
    c.get_or_build(ws[1], cfg(4, 8), version=("l", 0),
                   backend=name["engine_cuda"])
    c.get_or_build(ws[1], cfg(4, 8), version=("l", 0))
    c.run(ws[2], x, cfg(4, 8))
    c.get_or_build(ws[3], cfg(4, 8))                 # evicts the oldest
    c.get_or_build(ws[0], cfg(4, 8), backend=name["engine_torch"])
    c.invalidate(ws[1])
    c.get_or_build(ws[2], cfg(4, 8), version="v")
    c.invalidate_version("v")
    c.get_or_build(ws[4], cfg(4, 8, 2))
    first = c.stats()
    c.clear()
    c.get_or_build(ws[0], cfg(4, 8))
    return first, c.stats(), len(c)


def test_counters_equal_the_reference_cache(rng):
    """The same calls give the reference's hits, misses, evictions,
    invalidations, size and per-backend counts (the port's backend names
    in place of the reference's)."""
    ws = [_w(rng) for _ in range(5)]
    x = rng.integers(-128, 128, size=(32, 4))
    got = _sequence(PC, EngineConfig, ws, x, {n: n for n in _REF_NAME})
    want = _sequence(RC, RefEngineConfig, ws, x, _REF_NAME)
    rename = {v: k for k, v in _REF_NAME.items() if k}
    for g, r in zip(got[:2], want[:2]):
        r = {**r, "backends": {rename[b]: s
                               for b, s in r["backends"].items()}}
        assert g == r
    assert got[2] == want[2]
