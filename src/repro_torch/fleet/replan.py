"""Asynchronous re-planning for live-weight serving (port of
``repro.fleet.replan``).

Transitive Array's execution plans are functions of the weight
bit-patterns, so every weight update invalidates every plan (210 of them
for smollm-135m). This module keeps that cost off the serving thread:

  * :func:`build_generation` — the offline half for one set of weights:
    plan through the :class:`~repro_torch.core.plancache.PlanCache` (its
    coalescing keeps a concurrent lookup of the same weight from building
    twice), lower and pack the device plans, attach them and pad them
    against the serving generation (:func:`align_device_plans`). Every
    plan build and every pack of a swap happens here, on the caller's
    thread: the serving thread builds and packs nothing.
  * :class:`ReplanWorker` — a daemon thread that runs ``build_generation``
    on submitted weights, newest submission first, and hands finished
    generations to a callback (``ServeEngine.swap_params``). A failed
    build never reaches the engine: the serving generation keeps serving,
    which is the rollback.
  * :class:`WeightWatcher` — polls a checkpoint directory
    (``repro_torch.distributed.checkpoint``, the reference's format) and
    feeds new weights to the worker.

Eager PyTorch has no trace to keep, so pad alignment is not what makes a
swap cheap here; it is kept so a generation's DevicePlans have the
reference's leaf shapes, and ``swap_params`` counts any leaf-shape drift
as the reference does. With ``mesh=`` a generation's plans are placed on
the mesh after alignment (``specs=``, default the backend's
``plan_specs``: replicated), as ``attach_device_plans(mesh=)`` places
them; a ``ServeEngine(mesh=)`` on every rank then swaps to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable

import torch

from repro_torch.core import plancache
from repro_torch.core.backend import get_backend, shard_device_plan
from repro_torch.core.engine import (DevicePlan, ForestPlan,
                                     SparseForestPlan, pad_device_plan)

__all__ = ["Generation", "ReplanSuperseded", "ReplanTicket",
           "ReplanWorker", "WeightWatcher", "align_device_plans",
           "build_generation", "fingerprint_params"]

PLAN_TYPES = (DevicePlan, ForestPlan, SparseForestPlan)


def _leaves_with_path(tree: Any, path: str = ""):
    """``(path, leaf)`` in the reference's pytree order (dict keys sorted,
    lists in order), the path written as ``jax.tree_util.keystr`` writes
    it (``['blocks']['b0']['wq']['qw']``); None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _host_bytes(t: torch.Tensor) -> tuple[tuple, str, bytes]:
    """(shape, numpy's dtype string, bytes) of a tensor, as the reference
    hashes ``np.asarray`` of a JAX array: bfloat16 is ``ml_dtypes``'
    ``'<V2'`` there, its raw bits here."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return tuple(t.shape), "<V2", t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return a.shape, a.dtype.str, a.tobytes()


def fingerprint_params(params: Any) -> str:
    """Content hash of a params tree's weights: the generation identity the
    fleet coalesces and refuses on.

    Hashes every quantized-weight (``qw``) leaf when the tree has them (the
    plans depend on those only), else every tensor leaf, in the
    reference's walk order with its path, shape and dtype string, so the
    digest equals the reference's ``fingerprint_params`` on the same
    weights. Attached plans are skipped (derived from ``qw``)."""
    leaves = [(p, a) for p, a in _leaves_with_path(params)
              if not isinstance(a, PLAN_TYPES)]
    qw = [(p, a) for p, a in leaves if "['qw']" in p]
    h = hashlib.blake2b(digest_size=16)
    for path, leaf in (qw or leaves):
        shape, dtype, data = _host_bytes(torch.as_tensor(leaf))
        h.update(repr((path, shape, dtype)).encode())
        h.update(data)
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class Generation:
    """One fully built weight generation, ready to attach to an engine."""
    gen: int
    params: Any                # device plans attached (if planned)
    fingerprint: str           # fingerprint_params of the input weights
    tag: Any = None            # caller's label (checkpoint step, ...)
    build_s: float = 0.0       # wall seconds build_generation spent
    plans_built: int = 0       # cold plan builds (cache misses) it caused


def _round_pad(n: int) -> int:
    """Next power of two >= n (>= 8): headroom so the next generation's
    direct width likely fits without growing the leaf again."""
    b = 8
    while b < n:
        b *= 2
    return b


def _walk_dplans(tree: Any, ref: Any, fn: Callable) -> Any:
    """Rebuild ``tree`` with ``fn(dplan, ref_dplan_or_None)`` applied to
    every attached DevicePlan; ForestPlans and SparseForestPlans pass
    through."""
    if isinstance(tree, dict):
        out = {k: _walk_dplans(v,
                               ref.get(k) if isinstance(ref, dict) else None,
                               fn)
               for k, v in tree.items()}
        if isinstance(tree.get("dplan"), DevicePlan):
            r = ref.get("dplan") if isinstance(ref, dict) else None
            out["dplan"] = fn(tree["dplan"],
                              r if isinstance(r, DevicePlan) else None)
        return out
    if isinstance(tree, list):
        ref = ref if isinstance(ref, list) else [None] * len(tree)
        return [_walk_dplans(v, r, fn) for v, r in zip(tree, ref)]
    if isinstance(tree, tuple):
        ref = ref if isinstance(ref, tuple) else (None,) * len(tree)
        return tuple(_walk_dplans(v, r, fn) for v, r in zip(tree, ref))
    return tree


def _map_plans(tree: Any, fn: Callable) -> Any:
    """Rebuild ``tree`` with ``fn(plan)`` applied to every attached plan
    (DevicePlan, ForestPlan or SparseForestPlan)."""
    if isinstance(tree, dict):
        return {k: _map_plans(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_plans(v, fn) for v in tree)
    return fn(tree) if isinstance(tree, PLAN_TYPES) else tree


def align_device_plans(params: Any, ref_params: Any | None) -> Any:
    """Pad ``params``' attached DevicePlans to the leaf shapes of
    ``ref_params``' (the serving generation), as the reference does.

    A DevicePlan's direct-dispatch width ``D`` is its one leaf dimension
    that depends on weight content. Where the new width fits under the
    reference's it is padded to exactly that width; where it outgrew it,
    to a power-of-two bound; with no reference (a cold start), every plan
    to its power-of-two bound. Padding is bit-exact
    (:func:`~repro_torch.core.engine.pad_device_plan`). Plans whose
    signature (t/bits/n/k/groups) differs are left alone.

    ``engine_cuda``'s plans pass through: a :class:`ForestPlan`'s leaves
    (``producer`` (J, 2^T), ``rows`` (J, S, N), ``signs`` (S,)) depend on
    the layer signature only, so they never drift; a
    :class:`SparseForestPlan`'s ``codes`` width U (its largest tile's made
    nodes, rounded up to 4) depends on weight content, and its other
    leaves do not. ``ServeEngine.swap_params`` counts leaf-shape drift
    over these leaves as over a DevicePlan's (``swap_shape_drift``)."""
    if ref_params is None:
        return _walk_dplans(
            params, None,
            lambda d, r: pad_device_plan(
                d, _round_pad(int(d.direct_idx.shape[-1]))))

    def align(d: DevicePlan, r: DevicePlan | None) -> DevicePlan:
        if r is None or (d.t, d.bits, d.n, d.k, d.groups) != (
                r.t, r.bits, r.n, r.k, r.groups):
            return d
        need = int(d.direct_idx.shape[-1])
        have = int(r.direct_idx.shape[-1])
        return pad_device_plan(d, have if need <= have else _round_pad(need))

    return _walk_dplans(params, ref_params, align)


def build_generation(model, params, *, ref: Any = None, gen: int = 0,
                     tag: Any = None, cache=None, mesh=None,
                     specs=None) -> Generation:
    """Plan, lower, pack, attach and align one weight generation.

    ``params`` are raw weights (no plans); ``ref`` the serving generation's
    attached params, used for pad alignment only (None for a cold start).
    Plans build through ``cache`` (default: the process cache). A config
    that does not plan passes ``params`` through (the generation is then a
    tagged params handle). Raises whatever the build raises:
    :class:`ReplanWorker` turns that into "keep serving the previous
    generation". ``mesh=`` places every attached plan on it after
    alignment (``specs``: ``shard_device_plan``'s forms; default the
    backend's ``plan_specs(mesh)``)."""
    t0 = time.perf_counter()
    cache = plancache.default_cache() if cache is None else cache
    fp = fingerprint_params(params)
    q = getattr(model.cfg, "quant", None)
    built = 0
    attached = params
    if q is not None and q.mode == "ptq":
        b = get_backend(q)
        if b.needs_plan:
            built = plancache.precompile(params, q, cache)["built"]
        if b.needs_plan and b.device_resident:
            attached = plancache.attach_device_plans(params, q, cache)
            attached = align_device_plans(attached, ref)
            if mesh is not None:
                sp = specs if specs is not None else b.plan_specs(mesh)
                attached = _map_plans(
                    attached, lambda d: shard_device_plan(d, mesh, sp))
    return Generation(gen=gen, params=attached, fingerprint=fp, tag=tag,
                      build_s=time.perf_counter() - t0, plans_built=built)


class ReplanSuperseded(RuntimeError):
    """A queued (not yet started) replan was replaced by newer weights
    before its build began; its ticket resolves with this error."""


class ReplanTicket:
    """Handle on one submitted replan: wait on it, read the result."""

    def __init__(self, fingerprint: str):
        self.fingerprint = fingerprint
        self.generation: Generation | None = None
        self.error: BaseException | None = None
        self._event = threading.Event()

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the build finished (ok or failed); False on
        timeout."""
        return self._event.wait(timeout)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, generation=None, error=None) -> None:
        self.generation, self.error = generation, error
        self._event.set()

    def __repr__(self) -> str:
        state = ("pending" if not self.done else
                 "failed" if self.error is not None else "ready")
        return f"ReplanTicket({self.fingerprint[:8]}, {state})"


class ReplanWorker:
    """Background thread that rebuilds plan generations off the serving
    thread.

    ``submit(params)`` fingerprints the weights and returns a
    :class:`ReplanTicket` at once; the worker runs :func:`build_generation`
    and calls ``on_ready(generation)`` (wire it to
    ``ServeEngine.swap_params``, which only stages; the engine applies the
    swap at its next step boundary). On a failed build ``on_error(exc)``
    fires and nothing reaches the engine.

    A submit whose fingerprint matches the build in flight, the queued
    build or the last completed build returns that ticket. The queue is
    depth-1, newest wins: a superseded (never started) ticket resolves
    with :class:`ReplanSuperseded`. Each build is padded against the
    params of the last generation built (or ``reference=``, the engine's
    serving params).

    On a CUDA model the worker builds under a CUDA stream of its own, so
    its host-to-device copies of the packed plans do not queue behind the
    serving thread's kernels, and synchronizes that stream before it
    resolves the ticket or calls ``on_ready``: a generation handed to the
    engine never holds a plan whose copy is still in flight. (Its plan
    tensors stay allocated for the generation's life; the engine frees a
    retired generation only after its last decode step's tokens were read
    back, so no kernel still reads them.)

    ``mesh=`` places each generation's plans on the mesh under the
    backend's ``plan_specs`` (:func:`build_generation`). The built-in
    backends replicate, so the build makes no collective and the thread
    may run beside the serving thread on every rank; each rank's engine
    must still swap at the same step.
    """

    def __init__(self, model, *, cache=None, mesh=None,
                 reference: Any = None,
                 on_ready: Callable[[Generation], Any] | None = None,
                 on_error: Callable[[BaseException], Any] | None = None):
        self.model = model
        self.cache = cache
        self.mesh = mesh
        self.on_ready = on_ready
        self.on_error = on_error
        self._ref = reference
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._next: tuple[Any, Any, ReplanTicket] | None = None
        self._inflight: ReplanTicket | None = None
        self._last: ReplanTicket | None = None
        self._gen = 0
        self._thread: threading.Thread | None = None
        self.counters = {"submitted": 0, "coalesced": 0, "superseded": 0,
                         "built": 0, "failed": 0}

    # -- lifecycle ----------------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name="replan-worker",
                                            daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Stop after the in-flight build (if any) finishes."""
        with self._lock:
            self._stop = True
            nxt, self._next = self._next, None
        if nxt is not None:
            self.counters["superseded"] += 1
            nxt[2]._resolve(error=ReplanSuperseded("worker stopped"))
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def __enter__(self) -> "ReplanWorker":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- submission ---------------------------------------------------------
    def submit(self, params, *, tag: Any = None) -> ReplanTicket:
        """Schedule a rebuild for these weights; returns immediately."""
        fp = fingerprint_params(params)
        with self._lock:
            if self._stop:
                raise RuntimeError("ReplanWorker is stopped")
            self.counters["submitted"] += 1
            for t in (self._inflight, self._last):
                if (t is not None and t.fingerprint == fp
                        and t.error is None):
                    self.counters["coalesced"] += 1
                    return t
            if self._next is not None:
                if self._next[2].fingerprint == fp:
                    self.counters["coalesced"] += 1
                    return self._next[2]
                old = self._next[2]
                self.counters["superseded"] += 1
                old._resolve(error=ReplanSuperseded(
                    f"{old.fingerprint[:8]} superseded by {fp[:8]}"))
            ticket = ReplanTicket(fp)
            self._next = (params, tag, ticket)
        self._ensure_thread()
        self._wake.set()
        return ticket

    # -- the worker thread --------------------------------------------------
    def _build(self, params, tag, gen_id: int) -> Generation:
        """build_generation on this thread's own CUDA stream (if any),
        synchronized before the generation is handed on."""
        device = getattr(self.model, "device", torch.device("cpu"))
        stream = (torch.cuda.Stream(device=device)
                  if device.type == "cuda" else None)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            gen = build_generation(self.model, params, ref=self._ref,
                                   gen=gen_id, tag=tag, cache=self.cache,
                                   mesh=self.mesh)
        if stream is not None:
            stream.synchronize()
        return gen

    def _loop(self) -> None:
        while True:
            self._wake.wait()
            with self._lock:
                if self._stop and self._next is None:
                    return
                self._wake.clear()
                job, self._next = self._next, None
                if job is None:
                    continue
                params, tag, ticket = job
                self._inflight = ticket
                self._gen += 1
                gen_id = self._gen
            try:
                gen = self._build(params, tag, gen_id)
            except BaseException as e:  # noqa: BLE001 — the rollback path
                with self._lock:
                    self._inflight = None
                self.counters["failed"] += 1
                ticket._resolve(error=e)
                if self.on_error is not None:
                    self.on_error(e)
            else:
                with self._lock:
                    self._inflight = None
                    self._last = ticket
                    self._ref = gen.params
                self.counters["built"] += 1
                ticket._resolve(generation=gen)
                if self.on_ready is not None:
                    self.on_ready(gen)

    def stats(self) -> dict:
        with self._lock:
            return {**self.counters,
                    "inflight": self._inflight is not None,
                    "queued": self._next is not None}


class WeightWatcher:
    """Poll a checkpoint directory for new weights and feed them to a
    :class:`ReplanWorker`.

    ``ckpt_dir`` holds ``repro_torch.distributed.checkpoint`` checkpoints
    (``step_N/`` + a ``latest`` marker written last, so a half-written one
    is never picked up; the reference's ``checkpoint.save`` writes the
    same). ``template`` is a params tree of the expected structure
    (the raw params the engine started from): a restored leaf takes its
    template's dtype and device. The serving loop calls :meth:`poll`
    between steps: one small file read until a new step appears; then the
    restore and ``worker.submit`` run on the caller's thread, and the plan
    build on the worker's."""

    def __init__(self, ckpt_dir, template, worker: ReplanWorker):
        self.ckpt_dir = ckpt_dir
        self.template = template
        self.worker = worker
        self.seen_step: int | None = None

    def poll(self) -> ReplanTicket | None:
        """Check for a new checkpoint; submit it if found."""
        from repro_torch.distributed import checkpoint

        step = checkpoint.latest_step(self.ckpt_dir)
        if step is None or step == self.seen_step:
            return None
        params = checkpoint.restore(self.ckpt_dir, step, self.template)
        self.seen_step = step
        return self.worker.submit(params, tag=step)
