"""Continuous-batching serve engine over the paged KV pool (port of
``repro.serve.engine``).

:class:`ServeEngine` is the host scheduler: requests ``submit()`` at any
time, ``step()`` admits arrivals into free batch slots, runs **one packed
decode step** over every active slot, and retires finished requests —
freeing their pages and re-opening their slots. The device sees three
kinds of calls:

  * a **bucketed batched prefill** (``Model.prefill_paged_batched``):
    same-wave prefills whose suffixes round up to the same power-of-two
    bucket run as one padded call;
  * a per-request **suffix prefill** (``Model.prefill_paged``) when
    bucketing is off or the extent passes ``CHUNK_THRESHOLD``;
  * one fixed-shape **packed decode** (``Model.decode_step_paged``) over
    ``(n_slots, 1)`` tokens, the ``(n_slots, pages_per_slot)`` int32 page
    table and per-slot ``steps``. Inactive slots point at the null page and
    carry step 0. ``paged_kernel=True`` routes decode attention through the
    live-page CUDA kernel.

Prompt prefixes are shared through the :class:`PrefixTrie` at full-page
granularity. With an exact pool the shared range is skipped at compute
time; with an int8 pool (``kv_cache_bits=8``) it is recomputed (the dense
reference attends over full-precision K/V during prefill) but its pages
are still shared. Every request's tokens equal running it alone through
``greedy_generate`` with the same ``max_len``.

Weights hot-swap without draining: the per-weight state (params, page
pool, allocator, prefix trie, slot arrays) lives in a **generation cell**,
and :meth:`ServeEngine.swap_params` stages a new cell that is attached at
the next ``step()`` boundary, never mid-step. A request stays on the cell
that admitted it (its K/V bytes are a function of its tokens and of the
weights) until its last token; requests admitted after the swap run on
the new generation, and each live cell runs its own packed decode in a
step. ``swap_params`` only stages, under a lock, so a replan worker
thread may call it (``repro_torch.fleet``).

``mesh=`` (a DeviceMesh over the ``pod`` / ``data`` axes) serves the
engine data-parallel in eager SPMD. Every rank of the mesh builds the
same engine and is handed the same requests; the host scheduler runs the
same way on every rank. The packed slot arrays (tokens, page table,
steps) and a bucketed prefill's arrays go under the ``batch`` rule
(``train.serve_step._place_batch``): where the extent divides the rows,
each rank runs its own rows; where it does not (a bucket of 1 or 2 rows
on 4 ranks, a single-request prefill), every rank runs all of them, with
the ``ShardingDropWarning``. After a split call the ranks exchange, once,
through the host, each row's sampled token and the K/V rows it wrote, so
every rank sees every slot's token (to append it, check EOS and free
pages) and holds every written page.

The page pool is therefore **replicated**: every rank holds all
``n_pages`` pages, and after every call they are bit-identical on every
rank. (The other design, a pool sharded by page ranges with each rank's
slots allocating from its own range, would need a page allocator and a
prefix trie per rank and would forbid prefix sharing across ranks.) The
null page (page 0), which the dead rows of a packed call write and no
live row reads, is zeroed after every call on every rank, so it too is
the same everywhere. A model axis above 1 is refused (ROADMAP A10.2).

The port runs eagerly, so there is no jit trace to count; ``stats()``
keeps what a trace counter bounds: the distinct prefill shapes (what bucketing
bounds) and ``decode_signatures``, the distinct signatures the packed
decode ran with (every params and pool leaf's shape and dtype and the
batch shapes: a jit would retrace, a CUDA graph recapture, once per
signature; the reference's ``decode_jit_traces``). A staged
generation's plans pass the plan verifier's ``swap-staging`` gate first
(``repro_torch.analysis.planlint``; with ``REPRO_PLANLINT=0`` its
kernel guards still run).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.analysis import planlint
from repro_torch.analysis.walker import named_tensors
from repro_torch.core.engine import (DevicePlan, ForestPlan,
                                     SparseForestPlan)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.models.attention import CHUNK_THRESHOLD
from repro_torch.models.model import Model
from repro_torch.serve.paging import PageAllocator, PrefixTrie

__all__ = ["Request", "ServeEngine", "SwapMismatchError", "bucket"]


def bucket(n: int, cap: int) -> int:
    """Smallest power of two >= ``n``, clamped to ``cap``."""
    if n < 1:
        raise ValueError(f"bucket of non-positive {n}")
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class SwapMismatchError(ValueError):
    """``swap_params`` was handed params the engine cannot serve: their
    tree structure (keys, plan kinds and signatures) differs from the
    serving generation's. A hot swap replaces weight values and the plans
    riding with them, never the architecture: that needs a new engine."""


def _is_plan(x) -> bool:
    return isinstance(x, (DevicePlan, ForestPlan, SparseForestPlan))


def _structure(tree) -> Any:
    """The tree's structure without its values: dict keys, sequence
    lengths, and for an attached plan its kind and signature (the
    reference's pytree aux data); a tensor is a leaf."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_structure(v) for v in tree)
    if _is_plan(tree):
        return (type(tree).__name__, tree.t, tree.bits, tree.n, tree.k,
                tree.groups)
    return None if tree is None else "leaf"


def _leaves(tree) -> list:
    """Every tensor of the tree in one fixed order, an attached plan's
    leaves included."""
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _leaves(v)]
    if _is_plan(tree):
        return list(tree.leaves().values())
    return [] if tree is None else [tree]


@dataclasses.dataclass
class Request:
    """One generation request plus the engine's bookkeeping for it."""
    rid: int
    prompt: tuple
    max_new_tokens: int
    eos_id: int | None = None
    out: list = dataclasses.field(default_factory=list)
    page_ids: list = dataclasses.field(default_factory=list)
    slot: int | None = None
    gen: int = 0               # weight generation that admitted (owns) it
    length: int = 0            # K/V rows written: prompt, then +1 per step
    shared_pages: int = 0      # prompt pages taken from the prefix trie
    prefill_computed: int = 0  # prompt positions the prefill forward ran
    t_submit: float = 0.0
    t_admit: float | None = None
    t_done: float | None = None

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def tokens(self) -> list:
        """Generated token ids (token 0 is the prefill argmax)."""
        return list(self.out)


@dataclasses.dataclass
class _Cell:
    """One weight generation's serving state: everything whose bytes are a
    function of the weights (params, page pool, allocator, prefix trie,
    which indexes K/V bytes, and the packed slot arrays). A hot swap
    appends a cell; a request's generation is the cell that admitted
    it."""
    gen: int
    params: Any
    pool: Any
    alloc: PageAllocator
    trie: PrefixTrie
    slots: list
    tokens: np.ndarray
    steps: np.ndarray
    table: np.ndarray
    tag: Any = None            # caller's label (checkpoint step, ...)
    signature: tuple = ()      # the packed decode's (ServeEngine._new_cell)
    decoded: bool = False      # its signature counted in decode_signatures

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)


class ServeEngine:
    """Paged-KV continuous-batching scheduler around one model.

    ``n_slots`` fixes the packed decode batch; ``max_len`` bounds any
    request's total (prompt + generated - 1) positions and must be a
    multiple of ``page_size``. ``n_pages`` defaults to
    ``n_slots * max_len / page_size + 1`` (page 0 is the null page).
    ``device`` must be the model's device; it defaults to ``cuda`` like
    every entry point of the port.

    Weights swap at runtime through :meth:`swap_params`;
    ``params``/``pool``/``alloc``/``trie``/``slots`` read the current
    generation's cell. ``mesh=`` serves on a data mesh (module
    docstring); params whose plans were placed on it are read as each
    rank holds them.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 n_pages: int | None = None, mesh=None,
                 paged_kernel: bool = False, bucket_prefill: bool = True,
                 device=None):
        if mesh is not None:
            sharding.require_batch_mesh(mesh, "ServeEngine(mesh=)")
        self.mesh = mesh
        self.decode_placements: dict = {}
        self.device = resolve_device(device)
        if self.device != model.device:
            raise ValueError(f"engine device {self.device} differs from "
                             f"the model's {model.device}")
        reason = model.supports_paged()
        if reason is not None:
            raise NotImplementedError(f"paged serving: {reason}")
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if max_len % page_size:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) so a slot's page table covers it exactly")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_slot = max_len // page_size
        self.n_pages = (n_slots * self.pages_per_slot + 1
                        if n_pages is None else n_pages)
        self.paged_kernel = bool(paged_kernel)
        self.bucket_prefill = bool(bucket_prefill)
        self.exact_pool = model.cfg.kv_cache_bits != 8
        # generation cells: [-1] is current (it admits), earlier ones drain
        # their in-flight requests on their own weights
        self._cells: list[_Cell] = [
            self._new_cell(0, sharding.local_tree(params))]
        self._staged: tuple | None = None
        self._swap_lock = threading.Lock()
        self.swap_steps: list[int] = []
        self.queue: deque[Request] = deque()
        self.active: dict[int, Request] = {}
        self.finished: list[Request] = []
        self.step_count = 0
        self._next_rid = 0
        self._shape_keys: set = set()
        self._decode_signatures: set = set()
        self.counters = {"admitted": 0, "completed": 0, "decode_steps": 0,
                         "decode_tokens": 0, "prefix_hits": 0,
                         "pages_shared": 0, "prefill_computed": 0,
                         "prefill_skipped": 0, "prefill_written": 0,
                         "prefill_calls": 0, "prefill_batched_calls": 0,
                         "prefill_batched_rows": 0, "prefill_pad_rows": 0,
                         "bucket_hits": 0, "swaps": 0, "swaps_staged": 0,
                         "swaps_superseded": 0, "swap_shape_drift": 0,
                         "generations_retired": 0}

    def _new_cell(self, gen: int, params, tag=None) -> _Cell:
        # persistent host page table / tokens / steps; only per-slot deltas
        # are written between steps
        pool = self.model.init_page_pool(self.n_pages, self.page_size)
        tokens = np.zeros((self.n_slots, 1), np.int32)
        steps = np.zeros((self.n_slots,), np.int32)
        table = np.zeros((self.n_slots, self.pages_per_slot), np.int32)
        signature = (tuple((tuple(a.shape), a.dtype)
                           for a in _leaves(params) + _leaves(pool)),
                     tokens.shape, table.shape, steps.shape)
        return _Cell(
            gen=gen, params=params, pool=pool,
            alloc=PageAllocator(self.n_pages),
            trie=PrefixTrie(self.page_size),
            slots=[None] * self.n_slots, tokens=tokens, steps=steps,
            table=table, tag=tag, signature=signature)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- current-generation views (admission target; old cells drain) ------
    @property
    def cell(self) -> _Cell:
        return self._cells[-1]

    @property
    def generation(self) -> int:
        return self.cell.gen

    @property
    def params(self):
        return self.cell.params

    @property
    def pool(self):
        return self.cell.pool

    @property
    def alloc(self) -> PageAllocator:
        return self.cell.alloc

    @property
    def trie(self) -> PrefixTrie:
        return self.cell.trie

    @property
    def slots(self) -> list:
        return self.cell.slots

    @property
    def n_active(self) -> int:
        return self.cell.n_active

    # -- hot swap -----------------------------------------------------------
    def swap_params(self, params, *, tag=None) -> int:
        """Stage a weight-generation swap; returns the new generation id.

        Applied at the start of the next :meth:`step`, never mid-step.
        Non-draining: requests in flight keep decoding on the generation
        that admitted them (its cell stays alive until they finish);
        requests admitted after the swap run on the new weights. This only
        stages, under a lock, so a background replan worker may call it.
        Staging again before the next step supersedes the earlier staged
        params (``swaps_superseded``).

        ``params`` must have the serving generation's structure (else
        :class:`SwapMismatchError`: the caller's rollback is not to swap),
        and every attached plan must pass the plan verifier's
        ``swap-staging`` gate (else ``PlanVerificationError``: nothing is
        staged; with the gates off, its kernel guards still run). Leaf-shape drift is allowed (a DevicePlan's
        direct width past its pad, a SparseForestPlan's table width) and
        counted in ``swap_shape_drift``."""
        params = sharding.local_tree(params)
        cur = self.cell.params
        if _structure(params) != _structure(cur):
            raise SwapMismatchError(
                "swap_params: new params tree structure differs from the "
                "serving generation's — a hot swap replaces weight values, "
                "not model architecture (build a new engine for that)")
        planlint.gate_params(params, where="swap-staging",
                             guard_kernel=True)
        drift = sum(a.shape != b.shape or a.dtype != b.dtype
                    for a, b in zip(_leaves(params), _leaves(cur)))
        with self._swap_lock:
            superseded = self._staged is not None
            self._staged = (params, tag, drift)
        self.counters["swaps_staged"] += 1
        if superseded:
            self.counters["swaps_superseded"] += 1
        return self.cell.gen + 1

    def _apply_staged(self) -> None:
        """Attach a staged generation (scheduling thread, step boundary)."""
        with self._swap_lock:
            staged, self._staged = self._staged, None
        if staged is None:
            return
        params, tag, drift = staged
        self._cells.append(self._new_cell(self.cell.gen + 1, params,
                                          tag=tag))
        self.counters["swaps"] += 1
        self.counters["swap_shape_drift"] += drift
        self.swap_steps.append(self.step_count)

    def _retire_cells(self) -> None:
        """Drop old generations whose last in-flight request finished
        (frees their pool and trie); the current cell always stays."""
        for cell in [c for c in self._cells[:-1] if c.n_active == 0]:
            self._cells.remove(cell)
            self.counters["generations_retired"] += 1

    def _cell_of(self, gen: int) -> _Cell:
        for cell in self._cells:
            if cell.gen == gen:
                return cell
        raise KeyError(f"generation {gen} already retired")

    # -- submission --------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int,
               eos_id: int | None = None) -> int:
        """Queue a request; returns its id. Admission happens in step()."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) - 1 exceeds max_len ({self.max_len})")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid=rid, prompt=prompt,
                                  max_new_tokens=int(max_new_tokens),
                                  eos_id=eos_id,
                                  t_submit=time.perf_counter()))
        return rid

    # -- scheduling --------------------------------------------------------
    def _alloc_page(self, cell: _Cell) -> int | None:
        """One page, evicting trie-only pages (LRU) under pressure."""
        pid = cell.alloc.alloc()
        if pid is None and cell.trie.evict(cell.alloc, 1):
            pid = cell.alloc.alloc()
        return pid

    def _reserve(self, req: Request) -> dict | None:
        """Match/pin/allocate ``req``'s prompt pages; None = no pages yet.
        The prompt is indexed into the trie immediately, so later
        reservations of the same wave already share its pages. Always
        against the current cell: only the current generation admits."""
        cell = self.cell
        L, ps = len(req.prompt), self.page_size
        n_prompt_pages = -(-L // ps)
        # the suffix keeps >= 1 token: the last prompt position must run
        # through prefill to produce the step-0 logits
        shared = cell.trie.match(req.prompt, max_pages=(L - 1) // ps)
        for pid in shared:            # pin before eviction can see them
            cell.alloc.incref(pid)
        need = n_prompt_pages - len(shared)
        if cell.alloc.free_count < need:
            cell.trie.evict(cell.alloc, need - cell.alloc.free_count)
        if cell.alloc.free_count < need:
            for pid in shared:
                cell.alloc.decref(pid)
            return None
        page_ids = list(shared) + [cell.alloc.alloc() for _ in range(need)]
        cell.trie.insert(req.prompt, page_ids, cell.alloc)
        return {"req": req, "page_ids": page_ids, "shared": len(shared)}

    def _seat(self, res: dict, tok: int) -> None:
        """Post-prefill bookkeeping: record token, counters, slot/table."""
        cell = self.cell
        req = res["req"]
        L, ps = len(req.prompt), self.page_size
        shared = res["shared"]
        shared_len = shared * ps
        start = shared_len if self.exact_pool else 0
        req.gen = cell.gen
        req.out.append(tok)
        req.length = L
        req.page_ids = res["page_ids"]
        req.shared_pages = shared
        req.prefill_computed = L - start
        req.t_admit = time.perf_counter()
        c = self.counters
        c["admitted"] += 1
        c["prefix_hits"] += bool(shared)
        c["pages_shared"] += shared
        c["prefill_computed"] += L - start
        c["prefill_skipped"] += shared_len
        c["prefill_written"] += L - shared_len
        if len(req.out) >= req.max_new_tokens or tok == req.eos_id:
            self._finish(req)
        else:
            slot = cell.slots.index(None)
            req.slot = slot
            cell.slots[slot] = req.rid
            self.active[req.rid] = req
            cell.tokens[slot, 0] = tok
            cell.steps[slot] = req.length
            cell.table[slot, :len(req.page_ids)] = req.page_ids

    def _prefill_one(self, res: dict) -> None:
        """Per-request batch-1 prefill."""
        cell = self.cell
        req, page_ids = res["req"], res["page_ids"]
        L, ps = len(req.prompt), self.page_size
        shared_len = res["shared"] * ps
        if self.exact_pool:
            start, write_from = shared_len, 0   # skip shared compute
        else:
            start, write_from = 0, shared_len   # recompute, share bytes
        suffix = np.asarray([req.prompt[start:]], np.int32)
        prefix = np.asarray(page_ids[:start // ps], np.int32)
        wp = np.asarray([page_ids[p // ps] for p in range(shared_len, L)],
                        np.int32)
        wo = np.asarray([p % ps for p in range(shared_len, L)], np.int32)
        self.counters["prefill_calls"] += 1
        self._shape_keys.add(("one", L - start, start // ps, write_from))
        # one row: under a mesh every rank runs it (nothing to split)
        logits, cell.pool = self.model.prefill_paged(
            cell.params, self._dev(suffix), cell.pool,
            prefix_page_ids=self._dev(prefix),
            write_page_ids=self._dev(wp), write_offs=self._dev(wo),
            write_from=write_from)
        tok = int(torch.argmax(logits[:, -1], -1)[0])
        self._seat(res, tok)

    def _bucket_key(self, res: dict) -> tuple:
        """(suffix_bucket, n_prefix_pages) grouping key of a reservation;
        the prefix page count stays exact (padding it would interleave
        zero lanes mid-extent)."""
        L, ps = len(res["req"].prompt), self.page_size
        start = res["shared"] * ps if self.exact_pool else 0
        return bucket(L - start, self.max_len), start // ps

    def _prefill_group(self, group: list[dict]) -> None:
        """One padded batched prefill over same-bucket reservations."""
        cell = self.cell
        ps = self.page_size
        lb, n_pre = self._bucket_key(group[0])
        if not self.bucket_prefill or n_pre * ps + lb > CHUNK_THRESHOLD:
            for res in group:
                self._prefill_one(res)
            return
        nb = bucket(len(group), self.n_slots)
        tokens = np.zeros((nb, lb), np.int32)
        prefix = np.zeros((nb, n_pre), np.int32)
        plens = np.zeros((nb,), np.int32)
        slens = np.ones((nb,), np.int32)    # dead rows read garbage row 0
        wp = np.zeros((nb, lb), np.int32)   # dead lanes hit the null page
        wo = np.zeros((nb, lb), np.int32)
        wpos = np.zeros((nb, lb), np.int32)
        for r, res in enumerate(group):
            req, page_ids = res["req"], res["page_ids"]
            L = len(req.prompt)
            shared_len = res["shared"] * ps
            start = shared_len if self.exact_pool else 0
            ls = L - start
            tokens[r, :ls] = req.prompt[start:]
            plens[r] = start
            prefix[r, :start // ps] = page_ids[:start // ps]
            slens[r] = ls
            for i, p in enumerate(range(shared_len, L)):
                wp[r, i] = page_ids[p // ps]
                wo[r, i] = p % ps
                wpos[r, i] = p - start
        c = self.counters
        c["prefill_batched_calls"] += 1
        c["prefill_batched_rows"] += len(group)
        c["prefill_pad_rows"] += nb - len(group)
        key = ("batched", nb, lb, n_pre)
        if key in self._shape_keys:
            c["bucket_hits"] += 1
        self._shape_keys.add(key)
        args, split = self._rows({
            "tokens": tokens, "prefix": prefix, "plens": plens,
            "slens": slens, "wp": wp, "wo": wo, "wpos": wpos})
        logits, cell.pool = self.model.prefill_paged_batched(
            cell.params, args["tokens"], cell.pool,
            prefix_page_ids=args["prefix"], prefix_lens=args["plens"],
            suffix_lens=args["slens"], write_page_ids=args["wp"],
            write_offs=args["wo"], write_pos=args["wpos"])
        toks = self._sampled(cell, logits, (wp, wo) if split else None)
        for r, res in enumerate(group):
            self._seat(res, int(toks[r]))

    def _admit(self) -> None:
        while self.queue and None in self.slots:
            free = self.slots.count(None)
            wave: list[dict] = []
            while self.queue and len(wave) < free:
                res = self._reserve(self.queue[0])
                if res is None:
                    break             # page pressure: retry next step
                self.queue.popleft()
                wave.append(res)
            if not wave:
                break
            # a reservation whose shared pages are WRITTEN by an earlier
            # same-wave reservation prefills after the batch that fills them
            runs: list[list[dict]] = []
            cur: list[dict] = []
            pending_writes: set[int] = set()
            for res in wave:
                shared_ids = set(res["page_ids"][:res["shared"]])
                if cur and (shared_ids & pending_writes):
                    runs.append(cur)
                    cur, pending_writes = [], set()
                cur.append(res)
                pending_writes |= set(res["page_ids"][res["shared"]:])
            if cur:
                runs.append(cur)
            for run in runs:
                groups: dict[tuple, list[dict]] = {}
                for res in run:
                    groups.setdefault(self._bucket_key(res),
                                      []).append(res)
                for group in groups.values():
                    self._prefill_group(group)

    def _finish(self, req: Request) -> None:
        cell = self._cell_of(req.gen)
        if req.slot is not None:
            cell.slots[req.slot] = None
            del self.active[req.rid]
            cell.tokens[req.slot, 0] = 0
            cell.steps[req.slot] = 0
            cell.table[req.slot, :] = 0
            req.slot = None
        for pid in req.page_ids:
            cell.alloc.decref(pid)    # trie-held pages survive (refcount)
        req.t_done = time.perf_counter()
        self.counters["completed"] += 1
        self.finished.append(req)

    # -- rows on the mesh ----------------------------------------------------
    def _rows(self, arrays: dict, record: bool = False
              ) -> tuple[dict, bool]:
        """A packed call's host arrays on the device, and whether the call
        is split: whole, or under a mesh this rank's rows of each (the
        ``batch`` rule; every row where the extent does not divide them).
        ``record`` keeps the placements (``decode_placements``; the pool
        is replicated)."""
        if self.mesh is None:
            return {k: self._dev(v) for k, v in arrays.items()}, False
        from repro_torch.train.serve_step import _place_batch
        placed = _place_batch({k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in arrays.items()}, self.mesh)
        if record:
            from torch.distributed.tensor import Replicate
            self.decode_placements = {
                **{k: v.placements for k, v in placed.items()},
                "pool": (Replicate(),) * self.mesh.ndim}
        split = any(p.is_shard() for p in placed["tokens"].placements)
        return {k: v.to_local() for k, v in placed.items()}, split

    def _sampled(self, cell: _Cell, logits, written) -> np.ndarray:
        """Every row's greedy token on the host. ``written`` is None, or,
        for a split call, the (pages, offsets) arrays of the K/V positions
        each row wrote (row ``r``: ``(pages[r, i], offs[r, i])``): the
        ranks then exchange their rows' tokens and K/V rows in one host
        all-gather, and each writes the others' rows into its pool. Under
        a mesh the null page is then zeroed (module docstring)."""
        toks = torch.argmax(logits[:, -1], -1)
        if self.mesh is None:
            return toks.cpu().numpy()
        toks = toks.to(torch.int32)                # the exchange's buffer
        if written is not None:
            toks = self._exchange(cell, toks, *written)
        for leaf in named_tensors(cell.pool).values():
            leaf[:, 0].zero_()
        return toks.cpu().numpy()

    def _exchange(self, cell: _Cell, toks: torch.Tensor, pages: np.ndarray,
                  offs: np.ndarray) -> torch.Tensor:
        """Every rank's tokens, in row order, after one host all-gather of
        each rank's tokens and the pool rows its rows wrote; the others'
        rows are written into this rank's pool."""
        mesh = self.mesh
        k = toks.shape[0]                          # rows per rank
        me = sharding.batch_index(mesh)
        leaves = list(named_tensors(cell.pool).values())

        def where(q):
            p = torch.as_tensor(pages[q * k:(q + 1) * k].reshape(-1),
                                dtype=torch.long, device=self.device)
            o = torch.as_tensor(offs[q * k:(q + 1) * k].reshape(-1),
                                dtype=torch.long, device=self.device)
            return p, o
        p, o = where(me)
        parts = [toks.reshape(-1)] + [a[:, p, o] for a in leaves]
        sizes = [t.numel() * t.element_size() for t in parts]
        buf = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                         for t in parts])
        got = sharding.host_all_gather(buf, mesh)
        out = []
        for q, raw in enumerate(got):
            chunks = torch.split(raw.to(self.device), sizes)
            out.append(chunks[0].clone().view(torch.int32))
            if q == me:
                continue
            pq, oq = where(q)
            for a, c, t in zip(leaves, chunks[1:], parts[1:]):
                a[:, pq, oq] = c.clone().view(a.dtype).reshape(t.shape)
        return torch.cat(out)

    def _decode(self, cell: _Cell, packed: list[tuple[int, Request]]
                ) -> None:
        """One packed decode over ``cell``'s active slots."""
        self.counters["decode_steps"] += 1
        if not cell.decoded:
            cell.decoded = True
            self._decode_signatures.add(cell.signature)
        for s, req in packed:
            # this step writes K/V position req.length — grow the request's
            # table when it crosses a page boundary
            if req.length // self.page_size >= len(req.page_ids):
                pid = self._alloc_page(cell)
                if pid is None:
                    raise RuntimeError(
                        f"page pool exhausted ({cell.alloc!r}) — "
                        f"size n_pages for the slot working set")
                req.page_ids.append(pid)
                cell.table[s, len(req.page_ids) - 1] = pid
            cell.tokens[s, 0] = req.out[-1]
            cell.steps[s] = req.length
        args, split = self._rows({"tokens": cell.tokens,
                                  "table": cell.table, "steps": cell.steps},
                                 record=True)
        logits, cell.pool = self.model.decode_step_paged(
            cell.params, cell.pool, args["tokens"], args["table"],
            args["steps"], kernel=self.paged_kernel)
        written = None
        if split:                    # each slot wrote K/V position steps[s]
            page = cell.table[np.arange(self.n_slots),
                              cell.steps // self.page_size]
            written = (page[:, None], (cell.steps % self.page_size)[:, None])
        toks = self._sampled(cell, logits, written)
        done = []
        for s, req in packed:
            tok = int(toks[s])
            req.out.append(tok)
            req.length += 1
            self.counters["decode_tokens"] += 1
            if len(req.out) >= req.max_new_tokens or tok == req.eos_id:
                done.append(req)
        for req in done:
            self._finish(req)

    def step(self) -> list[Request]:
        """Attach a staged swap, admit arrivals, run one packed decode per
        live generation, retire finished requests and drained generations.

        Returns the requests that finished during this call. A staged swap
        is applied before admission, so requests taken off the queue this
        step already run on the new weights, while older generations keep
        decoding their in-flight requests in the same call."""
        n_done = len(self.finished)
        self._apply_staged()
        self._admit()
        packed_by_cell = [
            (cell, [(s, self.active[rid])
                    for s, rid in enumerate(cell.slots) if rid is not None])
            for cell in list(self._cells)]
        if any(packed for _, packed in packed_by_cell):
            self.step_count += 1
            for cell, packed in packed_by_cell:
                if packed:
                    self._decode(cell, packed)
        self._retire_cells()
        return self.finished[n_done:]

    def run(self, max_steps: int = 100_000) -> list[Request]:
        """Drive step() until every submitted request finished."""
        n_done = len(self.finished)
        steps = 0
        while self.queue or self.active:
            if steps >= max_steps:
                raise RuntimeError(f"run() exceeded {max_steps} steps")
            steps += 1
            before = (len(self.queue), len(self.active),
                      len(self.finished))
            self.step()
            if not self.active and before == (len(self.queue),
                                              len(self.active),
                                              len(self.finished)):
                raise RuntimeError(
                    f"scheduler stalled: {len(self.queue)} queued "
                    f"request(s) cannot be admitted "
                    f"(pages: {self.alloc!r}, trie: {self.trie!r})")
        return self.finished[n_done:]

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        active_by_gen: dict[int, int] = {}
        for r in self.active.values():
            active_by_gen[r.gen] = active_by_gen.get(r.gen, 0) + 1
        cur = self.cell.gen
        return {**self.counters, "queued": len(self.queue),
                "active": len(self.active),
                "finished": len(self.finished),
                "prefill_shapes": len(self._shape_keys),
                "decode_signatures": len(self._decode_signatures),
                "generation": cur,
                "draining_generations": len(self._cells) - 1,
                "active_by_gen": active_by_gen,
                "in_flight_prev_gen": sum(n for g, n in active_by_gen.items()
                                          if g != cur),
                "pages": self.alloc.stats(), "trie": self.trie.stats()}

    def report(self) -> dict:
        """Latency/throughput summary over the finished requests."""
        reqs = self.finished
        per = [{"rid": r.rid, "prompt_len": len(r.prompt),
                "n_tokens": len(r.out), "gen": r.gen,
                "shared_pages": r.shared_pages,
                "prefill_computed": r.prefill_computed,
                "ttft_s": (r.t_admit or r.t_submit) - r.t_submit,
                "latency_s": (r.t_done - r.t_submit) if r.done else None}
               for r in reqs]
        total_tokens = sum(len(r.out) for r in reqs)
        t0 = min((r.t_submit for r in reqs), default=0.0)
        t1 = max((r.t_done for r in reqs if r.done), default=t0)
        wall = max(t1 - t0, 1e-9)
        return {"requests": per, "n_requests": len(reqs),
                "total_tokens": total_tokens, "wall_s": wall,
                "tokens_per_s": total_tokens / wall,
                "counters": self.stats()}

    def __repr__(self) -> str:
        return (f"ServeEngine(gen={self.cell.gen} "
                f"slots={self.cell.n_active}/{self.n_slots} "
                f"queued={len(self.queue)} "
                f"finished={len(self.finished)} steps={self.step_count})")
