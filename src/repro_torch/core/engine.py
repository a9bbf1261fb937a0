"""Batched multi-tile transitive execution engine and device plans (port of
``repro.core.engine``).

The host half is a numpy copy of the reference: :class:`BatchedTransitiveEngine`
builds an :class:`ExecutionPlan` from a weight (bit-slice into TransRows,
one batched Scoreboard over all ``K//T`` tiles, level-synchronous forest
schedule) and :meth:`BatchedTransitiveEngine.run` executes it in int64.

The device half holds the plan as int32 tensors. :func:`compile_plan`
lowers an :class:`ExecutionPlan` to a :class:`DevicePlan` with the
reference's leaf names and values: gather-only per-level source maps over
the flat ``(J * 2^T, M)`` psum table, the direct-dispatch arrays, and the
APE gather table. :func:`run_device` executes it with plain torch gathers.

:func:`pack_forest_plan` repacks a tile-local :class:`DevicePlan` with T
<= 15 into the compact :class:`ForestPlan` the CUDA forest kernels
(:mod:`repro_torch.kernels.transitive_forest`) execute: one byte per
node (which bit produces it, or direct, or unused) and one byte per APE
gather up to T = 8, two from T = 9. :func:`forest_plan_plain` is those
kernels' plain version. From T = 16 a node no longer fits int16:
:func:`pack_sparse_forest_plan` repacks such a plan into a
:class:`SparseForestPlan` that keeps only the nodes the plan makes,
renumbered per tile in level order (slots), for the CUDA kernel of
``csrc/transitive_forest_sparse.cu``; :func:`sparse_forest_plain` is its
plain version.

Plans persist as the reference's ``.npz`` (:meth:`ExecutionPlan.save`,
:meth:`ExecutionPlan.load`, :meth:`ExecutionPlan.load_bundle`): the same
keys, a DevicePlan lowering under ``device_<field>`` for the same
``DEVICE_DATA_FIELDS``, so a file written by either package loads in the
other bit for bit; :class:`BundleMismatchError` refuses a file that does
not match the weights or the config it is loaded for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitslice, hasse
from repro_torch.core.scoreboard import (MAX_DISTANCE, ScoreboardInfo,
                                         dynamic_scoreboard)
from repro_torch.tracepoints import scope

__all__ = ["BatchedTransitiveEngine", "ExecutionPlan", "LevelStep",
           "DevicePlan", "PlanBundle", "BundleMismatchError",
           "DEVICE_DATA_FIELDS", "compile_plan",
           "compile_plans", "pad_device_plan", "check_tile_local",
           "forest_body", "run_device", "ForestPlan", "FOREST_DATA_FIELDS",
           "FOREST_DIRECT", "FOREST_UNUSED", "FOREST_MAX_T",
           "FOREST_WIDE_MAX_T", "forest_rows_dtype", "pack_forest_plan",
           "forest_plan_plain", "SparseForestPlan", "SPARSE_DATA_FIELDS",
           "SPARSE_DIRECT", "SPARSE_MAX_T", "SPARSE_MAX_SLOT",
           "sparse_forest_slots", "complete_forest_plan",
           "check_sparse_forest_plan", "sparse_forest_fault",
           "pack_sparse_forest_plan", "sparse_forest_plain"]


# DevicePlan's array leaves, in the reference's order.
DEVICE_DATA_FIELDS = ("level_src", "level_xsrc", "direct_idx",
                      "direct_x_idx", "direct_bits", "gather_idx", "signs")


class BundleMismatchError(ValueError):
    """A persisted plan bundle does not match what it is being attached to:
    raised by :meth:`ExecutionPlan.load_bundle` (weight fingerprint, shape
    or engine config) and by ``repro_torch.fleet.bundles`` (manifest-level
    refusals). A plan is a function of the weight bit-patterns, so a stale
    bundle would compute the old weights' GEMM; ``force=True`` on the
    loading API is the explicit escape hatch."""


@dataclasses.dataclass(frozen=True)
class LevelStep:
    """All forest edges of one Hamming level, across every tile."""
    tile: np.ndarray      # (E,) int64 — tile index of each executed node
    node: np.ndarray      # (E,) int64 — the node being computed
    prefix: np.ndarray    # (E,) int64 — its covering prefix (level - 1)
    bit: np.ndarray       # (E,) int64 — the single differing bit index


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Weight-only execution schedule — reusable across activations."""
    t: int                     # TransRow width
    bits: int                  # weight bit width S
    n: int                     # output rows
    k: int                     # reduction length (all groups concatenated)
    rows: np.ndarray           # (S, N, J) int64 TransRow values (APE gather)
    si: ScoreboardInfo         # batched scoreboard over all J tiles
    steps: tuple[LevelStep, ...]   # level-synchronous schedule, level 1..T
    direct_tile: np.ndarray    # (D,) int64 — outlier / prefix-less nodes
    direct_node: np.ndarray    # (D,) int64
    direct_bits: np.ndarray    # (D, T) int64 {0,1} — their bit patterns
    signs: np.ndarray          # (S,) int64 2's-complement plane weights
    groups: int = 1            # G quantization groups along K (1 = ungrouped)

    @property
    def n_tiles(self) -> int:
        return self.k // self.t

    # -- persistence (npz, the reference's keys) ----------------------------
    def save(self, path, *, device=None, backend: str | None = None,
             fingerprint: str | None = None) -> None:
        """Write the whole plan (schedule + scoreboard) to an ``.npz``.

        ``device=`` adds a compiled :class:`DevicePlan` (possibly stacked)
        tagged with the ``backend`` that lowered it; ``fingerprint=`` the
        content hash of the weights the plan was built from
        (``plancache.weight_fingerprint`` of the canonical int8 bytes),
        which :meth:`load_bundle` checks."""
        extra = {}
        if backend is not None and device is None:
            raise ValueError(
                "backend= tags the persisted device lowering; pass "
                "device= as well (a backend tag alone would be dropped "
                "silently on load)")
        if fingerprint is not None:
            extra["weight_fp"] = np.array(fingerprint)
        if device is not None:
            extra["device_meta"] = np.array(
                [device.t, device.bits, device.n, device.k, device.groups],
                np.int64)
            extra["device_backend"] = np.array(backend or "")
            for f in DEVICE_DATA_FIELDS:
                a = getattr(device, f)
                extra[f"device_{f}"] = (a.detach().cpu().numpy()
                                        if isinstance(a, torch.Tensor)
                                        else np.asarray(a))
        cat = (np.concatenate if self.steps else
               lambda _: np.zeros(0, np.int64))
        np.savez(
            path,
            **extra,
            meta=np.array([self.t, self.bits, self.n, self.k, self.groups,
                           self.si.t, self.si.n_rows], np.int64),
            rows=self.rows,
            steps_len=np.array([s.tile.size for s in self.steps], np.int64),
            steps_tile=cat([s.tile for s in self.steps]),
            steps_node=cat([s.node for s in self.steps]),
            steps_prefix=cat([s.prefix for s in self.steps]),
            steps_bit=cat([s.bit for s in self.steps]),
            direct_tile=self.direct_tile, direct_node=self.direct_node,
            direct_bits=self.direct_bits, signs=self.signs,
            si_counts=self.si.counts, si_exec_counts=self.si.exec_counts,
            si_bridge=self.si.bridge, si_distance=self.si.distance,
            si_prefix=self.si.prefix, si_lane=self.si.lane,
            si_outlier=self.si.outlier, si_wl_ppe=self.si.wl_ppe,
            si_wl_ape=self.si.wl_ape)

    @staticmethod
    def load(path) -> "ExecutionPlan":
        """Inverse of :meth:`save`, bit for bit."""
        with np.load(path) as z:
            return ExecutionPlan._from_npz(z)

    @staticmethod
    def _from_npz(z) -> "ExecutionPlan":
        t, bits, n, k, groups, si_t, si_n_rows = (int(v) for v in z["meta"])
        lens = z["steps_len"]
        bounds = np.cumsum(lens)[:-1]
        fields = (np.split(z[f"steps_{f}"], bounds) if lens.size else []
                  for f in ("tile", "node", "prefix", "bit"))
        steps = tuple(LevelStep(tile=tl, node=nd, prefix=pre, bit=bit)
                      for tl, nd, pre, bit in zip(*fields))
        si = ScoreboardInfo(
            t=si_t, n_rows=si_n_rows, counts=z["si_counts"],
            exec_counts=z["si_exec_counts"], bridge=z["si_bridge"],
            distance=z["si_distance"], prefix=z["si_prefix"],
            lane=z["si_lane"], outlier=z["si_outlier"],
            wl_ppe=z["si_wl_ppe"], wl_ape=z["si_wl_ape"])
        return ExecutionPlan(t=t, bits=bits, n=n, k=k, rows=z["rows"],
                             si=si, steps=steps,
                             direct_tile=z["direct_tile"],
                             direct_node=z["direct_node"],
                             direct_bits=z["direct_bits"],
                             signs=z["signs"], groups=groups)

    @staticmethod
    def load_bundle(path, *, qw=None, cfg=None,
                    force: bool = False) -> "PlanBundle":
        """Load a plan and, where the file carries one, its DevicePlan
        lowering (host tensors, tile locality checked once) and the
        backend name that made it.

        ``cfg=`` (``w_bits`` / ``t`` / ``groups``) and ``qw=`` (the weights
        the plan is about to serve) opt into the reference's checks, in
        its order: config, then shape (refused even with ``force``: such a
        plan could never run), then the stored fingerprint (a file without
        one refuses too). ``force=True`` skips the config and fingerprint
        refusals."""
        with np.load(path) as z:
            plan = ExecutionPlan._from_npz(z)
            stored_fp = (str(z["weight_fp"]) if "weight_fp" in z.files
                         else None)
            if "device_meta" not in z.files:
                device, backend = None, None
            else:
                t, bits, n, k, groups = (int(v) for v in z["device_meta"])
                leaves = {f: z[f"device_{f}"] for f in DEVICE_DATA_FIELDS}
                local = check_tile_local(
                    t, k, leaves["level_src"], leaves["level_xsrc"],
                    leaves["direct_idx"], leaves["direct_x_idx"],
                    leaves["gather_idx"])
                device = DevicePlan(
                    t=t, bits=bits, n=n, k=k, groups=groups,
                    tile_local=local, **{f: torch.from_numpy(
                        np.ascontiguousarray(a)) for f, a in leaves.items()})
                backend = str(z["device_backend"]) or None
        if cfg is not None:
            got = (plan.bits, plan.t, plan.groups)
            want = (cfg.w_bits, cfg.t, cfg.groups)
            if got != want and not force:
                raise BundleMismatchError(
                    f"{path}: plan (bits, t, groups)={got} does not match "
                    f"the serving config {want}; pass force=True to "
                    f"attach anyway")
        if qw is not None:
            from repro_torch.core.plancache import (_canonical,
                                                    weight_fingerprint)
            qw_c = _canonical(qw)
            if qw_c.shape != (plan.n, plan.k):
                raise BundleMismatchError(
                    f"{path}: plan is for weights (n, k)=({plan.n}, "
                    f"{plan.k}), got {qw_c.shape}")
            if not force:
                if stored_fp is None:
                    raise BundleMismatchError(
                        f"{path}: bundle carries no weight fingerprint "
                        f"(written without fingerprint=), so it cannot be "
                        f"validated against these weights; pass "
                        f"force=True to attach anyway")
                fp = weight_fingerprint(qw_c)
                if fp != stored_fp:
                    raise BundleMismatchError(
                        f"{path}: bundle was planned from weights "
                        f"{stored_fp}, but these weights hash to {fp} — "
                        f"a stale plan would compute the old weights' "
                        f"GEMM; pass force=True to attach anyway")
        return PlanBundle(plan=plan, device=device, backend=backend,
                          fingerprint=stored_fp)


class BatchedTransitiveEngine:
    """Plan/run split over the whole (N, K) weight at once.

    ``plan`` is the offline half (scoreboards + schedule from weights);
    ``run`` is the online half (psums + shift-accumulate from activations).
    ``__call__`` chains both for one-shot use.
    """

    def __init__(self, bits: int, t: int, max_distance: int = MAX_DISTANCE):
        self.bits = bits
        self.t = t
        self.max_distance = max_distance

    # -- offline: weights -> reusable schedule ---------------------------
    def plan(self, w: np.ndarray, groups: int = 1) -> ExecutionPlan:
        """Build the weight-only schedule.

        With ``groups=G`` the columns of ``w`` are G concatenated
        quantization groups of ``K//G`` each; the scoreboard/forest build is
        identical (it is already batched over k-tiles), only :meth:`run`'s
        final reduction changes to keep one partial sum per group. This is
        how all G groups of a group-quantized layer plan as a *single*
        batched tile axis instead of G separate engine invocations.
        """
        w = np.asarray(w)
        n, k = w.shape
        t = self.t
        if k % t:
            raise ValueError(f"K={k} not divisible by T={t}")
        if groups < 1 or k % groups or (k // groups) % t:
            raise ValueError(
                f"K={k} not divisible into {groups} T={t}-aligned groups")
        rows = bitslice.transrow_matrix(w, self.bits, t).astype(np.int64)
        n_tiles = k // t
        tile_rows = rows.transpose(2, 0, 1).reshape(n_tiles, -1)  # (J, S*N)
        si = dynamic_scoreboard(tile_rows, t, self.max_distance)

        executed = si.executed                       # (J, 2^T) bool
        # Nodes executed without a relay prefix (shouldn't occur for a
        # healthy scoreboard beyond level 1 roots, which use node 0) plus
        # outliers are dispatched directly as subset sums of their bits.
        prefixless = executed & (si.prefix < 0)
        direct = si.outlier | prefixless
        chained = executed & ~prefixless

        node_levels = hasse.levels(t)[None, :]       # (1, 2^T)
        lsb_of = np.full(1 << t, -1, dtype=np.int64)
        lsb_of[1 << np.arange(t)] = np.arange(t)

        steps = []
        for lv in range(1, t + 1):
            tl, nd = np.nonzero(chained & (node_levels == lv))
            if tl.size == 0:
                continue
            pre = si.prefix[tl, nd]
            diff = nd ^ pre
            bit = lsb_of[diff]
            # the balanced forest only emits covering (distance-1) edges;
            # a -1 here would silently gather the wrong activation row, so
            # fail loudly even under python -O
            if not (bit >= 0).all():
                raise ValueError("non-covering edge in scoreboard forest")
            steps.append(LevelStep(tile=tl, node=nd.astype(np.int64),
                                   prefix=pre.astype(np.int64), bit=bit))

        d_tile, d_node = np.nonzero(direct)
        d_bits = ((d_node[:, None] >> np.arange(t)) & 1).astype(np.int64)
        return ExecutionPlan(t=t, bits=self.bits, n=n, k=k, rows=rows, si=si,
                             steps=tuple(steps),
                             direct_tile=d_tile.astype(np.int64),
                             direct_node=d_node.astype(np.int64),
                             direct_bits=d_bits,
                             signs=bitslice.plane_signs(self.bits),
                             groups=groups)

    # -- online: activations through the planned forest ------------------
    def run(self, plan: ExecutionPlan, x: np.ndarray) -> np.ndarray:
        """Execute the planned forest against activations ``x`` (K, M).

        Returns (N, M) for an ungrouped plan; (N, G, M) per-group partial
        sums for a grouped one (epilogue rescaling happens in the caller).
        """
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[0] != plan.k:
            raise ValueError(f"x must be (K={plan.k}, M), got {x.shape}")
        m = x.shape[1]
        t, n_tiles = plan.t, plan.n_tiles
        size = 1 << t
        xt = x.reshape(n_tiles, t, m).astype(np.int64)     # (J, T, M)

        psum = np.zeros((n_tiles, size, m), dtype=np.int64)
        if plan.direct_tile.size:
            psum[plan.direct_tile, plan.direct_node] = np.einsum(
                "dt,dtm->dm", plan.direct_bits, xt[plan.direct_tile])
        for step in plan.steps:        # level-synchronous forest execution
            psum[step.tile, step.node] = (psum[step.tile, step.prefix]
                                          + xt[step.tile, step.bit])

        # APE shift-accumulate: gather every TransRow's psum and reduce
        # over each group's tiles, one vectorised pass per bit plane.
        flat = psum.reshape(n_tiles * size, m)
        gather_idx = np.arange(n_tiles, dtype=np.int64)[None, None, :] * size \
            + plan.rows                                     # (S, N, J)
        g, jg = plan.groups, n_tiles // plan.groups
        out = np.zeros((plan.n, g, m), dtype=np.int64)
        for s in range(plan.bits):
            gathered = flat[gather_idx[s]].reshape(plan.n, g, jg, m)
            out += plan.signs[s] * gathered.sum(axis=2)
        return out[:, 0] if g == 1 else out

    def __call__(self, w: np.ndarray, x: np.ndarray) -> np.ndarray:
        return self.run(self.plan(w), x)


# ---------------------------------------------------------------------------
# Device-resident plans: the level-synchronous forest as torch tensors
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DevicePlan:
    """A compiled execution schedule: int32 tensors, reference leaf names.

    All index arrays are flat: node ``v`` of tile ``j`` lives at row
    ``j * 2^T + v`` of the ``(J * 2^T, M)`` psum table and activation row
    ``b`` of tile ``j`` at row ``j * T + b`` of the ``(K, M)`` input. Each
    level holds a complete source map over all rows (executed rows gather
    their covering prefix plus one activation row, the rest gather
    themselves plus the pinned zero row ``K``). Direct-dispatch pad lanes
    target row ``J * 2^T``, one past the table.

    Leaves may carry leading stacked axes (one plan per stacked block
    weight); :meth:`index` slices them. ``tile_local`` records the CUDA
    kernel's precondition, checked once when the plan is built
    (:func:`check_tile_local`).
    """
    t: int
    bits: int
    n: int
    k: int
    groups: int
    level_src: torch.Tensor     # (T, R) int32
    level_xsrc: torch.Tensor    # (T, R) int32
    direct_idx: torch.Tensor    # (D,) int32 (pad: J*2^T)
    direct_x_idx: torch.Tensor  # (D, T) int32 (pad: 0)
    direct_bits: torch.Tensor   # (D, T) int32 {0,1} (pad: 0)
    gather_idx: torch.Tensor    # (S, N, J) int32
    signs: torch.Tensor         # (S,) int32
    tile_local: bool = False

    @property
    def n_tiles(self) -> int:
        return self.k // self.t

    @property
    def lead(self) -> tuple[int, ...]:
        """Leading stacked axes (``()`` for a single plan)."""
        return tuple(self.signs.shape[:-1])

    def leaves(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in DEVICE_DATA_FIELDS}

    def index(self, i) -> "DevicePlan":
        """The plan of stacked entry ``i`` (views, no copies)."""
        return dataclasses.replace(
            self, **{f: a[i] for f, a in self.leaves().items()})

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in self.leaves().values())


@dataclasses.dataclass(frozen=True)
class PlanBundle:
    """What :meth:`ExecutionPlan.load_bundle` returns: the host plan, its
    persisted DevicePlan lowering and the backend name that made it (None
    for a plan-only file), and the fingerprint of the weights the plan was
    built from (None for a file written without one)."""
    plan: ExecutionPlan
    device: DevicePlan | None
    backend: str | None
    fingerprint: str | None = None


def check_tile_local(t: int, k: int, level_src, level_xsrc, direct_idx,
                     direct_x_idx, gather_idx) -> bool:
    """Whether every forest edge stays inside its own T-tile.

    This is what lets one CUDA block own one tile's psum table in shared
    memory (kernels/transitive_forest.py): level sources and activation
    rows of a row in tile ``j`` lie in tile ``j`` (or are the pinned zero
    row ``K``); direct entries are sorted by target, real ones read their
    own tile's ``T`` activation rows in order, pads target ``J * 2^T``; and
    APE gathers index inside the table. ``compile_plan`` always emits such
    plans; the check runs once per plan on the host (numpy, any leading
    stacked axes).
    """
    size = 1 << t
    j = k // t
    r = j * size
    src = np.asarray(level_src, np.int64)
    xsrc = np.asarray(level_xsrc, np.int64)
    rows = np.arange(r, dtype=np.int64)
    if src.shape[-1] != r or xsrc.shape[-1] != r:
        return False
    if not ((src >= 0) & (src < r)).all():
        return False
    if not (src // size == rows // size).all():
        return False
    x_ok = (xsrc == k) | ((xsrc >= 0) & (xsrc < k)
                          & (xsrc // t == rows // size))
    if not x_ok.all():
        return False
    didx = np.asarray(direct_idx, np.int64)
    if didx.shape[-1] and (np.diff(didx, axis=-1) < 0).any():
        return False
    if not ((didx >= 0) & (didx <= r)).all():
        return False
    real = didx < r
    want_x = (didx // size)[..., None] * t + np.arange(t)
    dx = np.asarray(direct_x_idx, np.int64)
    if not (~real[..., None] | (dx == want_x)).all():
        return False
    g = np.asarray(gather_idx, np.int64)
    return bool(((g >= 0) & (g < r)).all())


def compile_plan(plan: ExecutionPlan, *, direct_pad: int | None = None,
                 device=None) -> DevicePlan:
    """Lower an :class:`ExecutionPlan` to int32 index tensors.

    Leaf for leaf the reference's ``compile_plan``. ``direct_pad`` widens
    the direct-dispatch axis so plans of one layer signature share leaf
    shapes (the precondition for stacking them, :func:`compile_plans`).
    ``device`` places the tensors (default: CPU).
    """
    t, size, j = plan.t, 1 << plan.t, plan.n_tiles
    invalid = j * size                       # one-past-end: dropped lanes
    r = j * size
    level_src = np.tile(np.arange(r, dtype=np.int32), (t, 1))
    level_xsrc = np.full((t, r), plan.k, np.int32)   # K = pinned zero row
    lvl_of = hasse.levels(t)
    for s in plan.steps:
        lv = int(lvl_of[int(s.node[0])])     # all nodes of a step share it
        rows = (s.tile * size + s.node).astype(np.int64)
        level_src[lv - 1, rows] = s.tile * size + s.prefix
        level_xsrc[lv - 1, rows] = s.tile * t + s.bit

    d_need = plan.direct_tile.size
    d = d_need if direct_pad is None else int(direct_pad)
    if d < d_need:
        raise ValueError(f"direct_pad={d} < direct nodes {d_need}")
    d = max(d, 1)
    direct_idx = np.full((d,), invalid, np.int32)
    direct_x_idx = np.zeros((d, t), np.int32)
    direct_bits = np.zeros((d, t), np.int32)
    if d_need:
        direct_idx[:d_need] = plan.direct_tile * size + plan.direct_node
        direct_x_idx[:d_need] = (plan.direct_tile[:, None] * t
                                 + np.arange(t, dtype=np.int64))
        direct_bits[:d_need] = plan.direct_bits

    gather_idx = (np.arange(j, dtype=np.int64)[None, None, :] * size
                  + plan.rows).astype(np.int32)
    local = check_tile_local(t, plan.k, level_src, level_xsrc, direct_idx,
                             direct_x_idx, gather_idx)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DevicePlan(
        t=t, bits=plan.bits, n=plan.n, k=plan.k, groups=plan.groups,
        level_src=as_t(level_src), level_xsrc=as_t(level_xsrc),
        direct_idx=as_t(direct_idx), direct_x_idx=as_t(direct_x_idx),
        direct_bits=as_t(direct_bits), gather_idx=as_t(gather_idx),
        signs=as_t(plan.signs.astype(np.int32)), tile_local=local)


def compile_plans(plans, *, device=None) -> DevicePlan:
    """Compile same-signature plans into ONE stacked DevicePlan.

    Pads every plan to the shared direct-dispatch bound, then stacks each
    leaf along a new leading axis (the stacked-block layout). Raises if
    signatures differ.
    """
    plans = list(plans)
    if not plans:
        raise ValueError("compile_plans needs at least one plan")
    sig = {(p.t, p.bits, p.n, p.k, p.groups) for p in plans}
    if len(sig) != 1:
        raise ValueError(f"cannot stack plans of differing signatures {sig}")
    d = max(p.direct_tile.size for p in plans)
    dps = [compile_plan(p, direct_pad=d) for p in plans]
    stacked = {f: torch.stack([getattr(dp, f) for dp in dps]).to(device)
               for f in DEVICE_DATA_FIELDS}
    return dataclasses.replace(
        dps[0], **stacked, tile_local=all(dp.tile_local for dp in dps))


def pad_device_plan(dplan: DevicePlan, direct_pad: int) -> DevicePlan:
    """Widen a compiled plan's direct-dispatch axis to ``direct_pad``.

    Pad lanes are the no-ops :func:`compile_plan` emits (target
    ``J * 2^T``, activation row 0, empty bit mask), so the padded plan
    computes identical results and stays tile-local. Works on stacked
    plans too (leading axes are preserved)."""
    d = int(dplan.direct_idx.shape[-1])
    pad = int(direct_pad)
    if pad < d:
        raise ValueError(f"direct_pad={pad} < current width {d}")
    if pad == d:
        return dplan
    lead = tuple(dplan.direct_idx.shape[:-1])
    invalid = dplan.n_tiles * (1 << dplan.t)
    kw = dict(dtype=dplan.direct_idx.dtype, device=dplan.direct_idx.device)
    pad_idx = torch.full(lead + (pad - d,), invalid, **kw)
    pad_2d = torch.zeros(lead + (pad - d, dplan.t), **kw)
    return dataclasses.replace(
        dplan,
        direct_idx=torch.cat([dplan.direct_idx, pad_idx], dim=-1),
        direct_x_idx=torch.cat([dplan.direct_x_idx, pad_2d], dim=-2),
        direct_bits=torch.cat([dplan.direct_bits, pad_2d], dim=-2))


def forest_body(xt, level_src, level_xsrc, direct_idx, direct_x_idx,
                direct_bits, gather_idx, signs, *, t: int, groups: int,
                n: int, k: int) -> torch.Tensor:
    """The forest schedule on plain tensors: int32 xt (K, M) -> (N, G, M).

    The reference's ``forest_body`` in torch. Two differences of idiom:
    torch has no dropping scatter, so the direct-dispatch table has one
    spare row at ``J * 2^T`` that the pad lanes land in and that is then
    sliced off; and torch sums integers in int64, so the APE sums are cast
    back to int32, which is congruent mod 2^32 with the reference's
    wrapping int32 accumulation.
    """
    size = 1 << t
    j = k // t
    r = j * size
    m = xt.shape[1]
    # pinned zero row at index K: identity lanes add nothing
    xt_ext = torch.cat([xt, xt.new_zeros((1, m))])

    # direct dispatch: subset sums of each outlier/root pattern's bits
    contrib = (direct_bits[:, :, None] * xt[direct_x_idx.long()]).sum(1)
    psum = xt.new_zeros((r + 1, m))
    psum[direct_idx.long()] = contrib.to(torch.int32)
    psum = psum[:r]

    # level-synchronous forest, gather-only: every row advances as
    # psum[src] + x[xsrc]; non-executed rows gather themselves + zero
    for lv in range(level_src.shape[0]):
        with scope("level", loop=True):
            psum = (psum.index_select(0, level_src[lv])
                    + xt_ext.index_select(0, level_xsrc[lv]))

    # APE shift-accumulate: gather every TransRow's psum, reduce per group
    s = signs.shape[0]
    jg = j // groups
    gathered = (psum.index_select(0, gather_idx.reshape(-1))
                .reshape(s, n, groups, jg, m).sum(3))        # int64
    out = (signs.long()[:, None, None, None] * gathered).sum(0)
    return out.to(torch.int32)


def run_device(dplan: DevicePlan, x: torch.Tensor) -> torch.Tensor:
    """Execute a compiled forest against activations ``x`` (K, M).

    Returns int32 (N, M) for an ungrouped plan, (N, G, M) per-group
    partials for a grouped one — bit-exact with the ``int_dot`` int32
    accumulator. The plain version of the CUDA forest kernel: it runs on
    whatever device ``x`` and the plan live on.
    """
    if x.ndim != 2 or x.shape[0] != dplan.k:
        raise ValueError(f"x must be (K={dplan.k}, M), got {tuple(x.shape)}")
    if dplan.lead:
        raise ValueError(f"run_device takes one plan, got stacked leading "
                         f"axes {dplan.lead}; slice with DevicePlan.index")
    out = forest_body(
        x.to(torch.int32), dplan.level_src, dplan.level_xsrc,
        dplan.direct_idx, dplan.direct_x_idx, dplan.direct_bits,
        dplan.gather_idx, dplan.signs, t=dplan.t, groups=dplan.groups,
        n=dplan.n, k=dplan.k)
    return out[:, 0] if dplan.groups == 1 else out


# ---------------------------------------------------------------------------
# The compact forest plan of the CUDA kernel
# ---------------------------------------------------------------------------

# ForestPlan's array leaves.
FOREST_DATA_FIELDS = ("producer", "rows", "signs")
# producer codes besides a bit index b < T
FOREST_DIRECT = 254     # subset sum of the tile's activations over v's bits
FOREST_UNUSED = 255     # stays 0 in the plain version; never read
FOREST_MAX_T = 8        # a gather fits one byte (uint8 rows)
FOREST_WIDE_MAX_T = 15  # a gather fits int16 (int16 rows); plans with a
                        # larger T pack into a SparseForestPlan


def forest_rows_dtype(t: int) -> torch.dtype:
    """The dtype of a ForestPlan's ``rows`` at width ``t``: uint8 up to
    ``FOREST_MAX_T``, int16 up to ``FOREST_WIDE_MAX_T``."""
    if t > FOREST_WIDE_MAX_T:
        raise ValueError(f"a ForestPlan holds a node index in int16: T <= "
                         f"{FOREST_WIDE_MAX_T}, got T={t}; such plans pack "
                         f"into a SparseForestPlan")
    return torch.uint8 if t <= FOREST_MAX_T else torch.int16


@dataclasses.dataclass(frozen=True, eq=False)
class ForestPlan:
    """A tile-local forest schedule in one byte per node and one byte (T <=
    8) or two (9 <= T <= 15) per gather.

    ``producer[j, v]`` says how node ``v`` of tile ``j`` is made: a bit
    ``b < T`` means ``psum[v] = psum[v ^ (1 << b)] + x[j * T + b]`` at
    level ``popcount(v)`` (so the prefix has one bit fewer, and one psum
    table per tile suffices when levels run in order); ``FOREST_DIRECT``
    means the subset sum of the tile's activations over ``v``'s bits;
    ``FOREST_UNUSED`` leaves it 0 (and nothing reads it).
    ``rows[j, s, n]`` is the node that output ``n`` gathers from tile
    ``j`` in bit plane ``s`` (the DevicePlan's ``gather_idx - j * 2^T``),
    laid out ``(J, S, N)`` with N fastest so neighbouring outputs read
    neighbouring bytes: uint8 for T <= ``FOREST_MAX_T``, int16 for T <=
    ``FOREST_WIDE_MAX_T`` (:func:`forest_rows_dtype`).

    Leaves may carry leading stacked axes like :class:`DevicePlan`'s;
    :meth:`index` slices them. Built by :func:`pack_forest_plan`. The
    kernel reads the leaves through raw pointers, so their dtype,
    contiguity and device are checked here, once per plan, not per call.
    """
    t: int
    bits: int
    n: int
    k: int
    groups: int
    producer: torch.Tensor      # (J, 2^T) uint8
    rows: torch.Tensor          # (J, S, N) uint8 (T <= 8) / int16
    signs: torch.Tensor         # (S,) int32

    def __post_init__(self):
        for name, dtype in (("producer", torch.uint8),
                            ("rows", forest_rows_dtype(self.t)),
                            ("signs", torch.int32)):
            a = getattr(self, name)
            if a.dtype != dtype or not a.is_contiguous():
                raise ValueError(f"ForestPlan.{name} must be contiguous "
                                 f"{dtype}, got {a.dtype} (contiguous: "
                                 f"{a.is_contiguous()})")
        devices = {a.device for a in self.leaves().values()}
        if len(devices) != 1:
            raise ValueError(f"ForestPlan leaves must share one device, got "
                             f"{sorted(map(str, devices))}")

    @property
    def n_tiles(self) -> int:
        return self.k // self.t

    @property
    def lead(self) -> tuple[int, ...]:
        """Leading stacked axes (``()`` for a single plan)."""
        return tuple(self.signs.shape[:-1])

    def leaves(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in FOREST_DATA_FIELDS}

    def index(self, i) -> "ForestPlan":
        """The plan of stacked entry ``i`` (views, no copies)."""
        return dataclasses.replace(
            self, **{f: a[i] for f, a in self.leaves().items()})

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in self.leaves().values())


def _pack_one(t: int, k: int, level_src, level_xsrc, direct_idx,
              direct_bits, gather_idx) -> tuple[np.ndarray, np.ndarray]:
    """(producer (J, 2^T) uint8, rows (J, S, N) int64: the gathered nodes)
    of one unstacked plan, after checking it (:func:`pack_forest_plan`
    lists the checks; :func:`pack_sparse_forest_plan` makes its slots from
    the same codes)."""
    size = 1 << t
    j = k // t
    r = j * size
    flat = np.arange(r, dtype=np.int64)
    node, tile = flat % size, flat // size
    level = hasse.levels(t)[node]
    producer = np.full(r, FOREST_UNUSED, np.uint8)
    prefixes = []
    for lv in range(t):
        src = level_src[lv].astype(np.int64)
        xsrc = level_xsrc[lv].astype(np.int64)
        step = xsrc != k
        if (src[~step] != flat[~step]).any():
            raise ValueError(f"level {lv + 1} copies a row it does not "
                             f"produce: not a forest schedule")
        bit = xsrc[step] - tile[step] * t
        v, pre = node[step], src[step] % size
        if not ((v ^ pre == 1 << bit) & ((v >> bit) & 1 == 1)
                & (level[step] == lv + 1)).all():
            raise ValueError(f"level {lv + 1} has an edge that does not add "
                             f"one bit to a prefix one level down")
        producer[step] = bit
        prefixes.append(src[step])
    didx = direct_idx.astype(np.int64)
    real = didx < r
    didx = didx[real]
    if (producer[didx] != FOREST_UNUSED).any() or (np.diff(didx) <= 0).any():
        raise ValueError("a direct node is also a level target or repeats")
    own = (node[didx][:, None] >> np.arange(t)) & 1
    if not (direct_bits[real] == own).all():
        raise ValueError("direct_bits differ from the direct node's own bits")
    producer[didx] = FOREST_DIRECT
    rows = gather_idx.astype(np.int64) - np.arange(j)[None, None, :] * size
    if rows.size and (rows.min() < 0 or rows.max() >= size):
        raise ValueError("an APE gather leaves its own tile")
    # the kernel leaves unused nodes unwritten: nothing may read one
    read = np.concatenate(prefixes + [gather_idx.reshape(-1)]).astype(
        np.int64)
    if ((producer[read] == FOREST_UNUSED) & (read % size != 0)).any():
        raise ValueError("the plan reads a node it never makes")
    return producer.reshape(j, size), rows.transpose(2, 0, 1)


def pack_forest_plan(dplan: DevicePlan, *, device=None) -> ForestPlan:
    """Repack a tile-local :class:`DevicePlan` as a :class:`ForestPlan`.

    Raises unless the plan is tile-local and T <= ``FOREST_WIDE_MAX_T`` =
    15 (a gathered node must fit int16; ``engine_cuda`` and the forest
    wrappers pack plans with a larger T with
    :func:`pack_sparse_forest_plan` instead), and unless every level edge
    adds one bit to a prefix one level down, no node is made twice, every
    direct node's bits are its own, and every node that a level or the APE
    reads is made (or is node 0, the empty sum): so an unused node's value
    is never read, and the kernel need not write it. Works on stacked
    plans. The leaves are made here, contiguous on ``device`` (default: the
    plan's): ``rows`` uint8 for T <= 8, int16 for 9 <= T <= 15. Counts its
    calls in ``pack_forest_plan.calls``.
    """
    pack_forest_plan.calls += 1
    return _pack_forest(dplan, device)


def _pack_forest(dplan: DevicePlan, device) -> ForestPlan:
    """:func:`pack_forest_plan` uncounted (the plan verifier's
    ``plan-forest-agreement`` packs with it)."""
    if not dplan.tile_local:
        raise ValueError("pack_forest_plan needs a tile-local plan (compile "
                         "it with compile_plan)")
    forest_rows_dtype(dplan.t)              # raises for T > 15
    leaves = {f: a.detach().cpu().numpy() for f, a in dplan.leaves().items()}
    for name, a in leaves.items():
        if a.dtype != np.int32:
            raise ValueError(f"plan leaf {name} must be int32, got "
                             f"{a.dtype}")
    lead = dplan.lead
    packed = [_pack_one(dplan.t, dplan.k, *(leaves[f][idx] for f in (
        "level_src", "level_xsrc", "direct_idx", "direct_bits",
        "gather_idx"))) for idx in np.ndindex(*lead)]
    producer = np.stack([p for p, _ in packed]).reshape(
        lead + packed[0][0].shape)
    rows_dtype = np.uint8 if dplan.t <= FOREST_MAX_T else np.int16
    rows = np.ascontiguousarray(np.stack([r for _, r in packed]).astype(
        rows_dtype).reshape(lead + packed[0][1].shape))
    device = dplan.signs.device if device is None else device
    return ForestPlan(
        t=dplan.t, bits=dplan.bits, n=dplan.n, k=dplan.k, groups=dplan.groups,
        producer=torch.from_numpy(producer).to(device),
        rows=torch.from_numpy(rows).to(device),
        signs=torch.from_numpy(leaves["signs"].copy()).to(device))


pack_forest_plan.calls = 0


def forest_plan_plain(fplan: ForestPlan, x: torch.Tensor) -> torch.Tensor:
    """Execute a :class:`ForestPlan` against activations ``x`` (K, M) in
    plain torch, level by level (popcount classes), on any device.

    Returns int32 (N, M) ungrouped, (N, G, M) grouped, bit-exact with
    :func:`run_device` on the plan it was packed from. The plain version
    of the CUDA forest kernel. The psum table is int32 (wrapping adds like
    the reference's); the APE sums run in int64 and are cast back, which
    is congruent mod 2^32. Like ``forest_body`` it runs the same ops on
    any values: gathers and selects only, no host read.
    """
    if x.ndim != 2 or x.shape[0] != fplan.k:
        raise ValueError(f"x must be (K={fplan.k}, M), got {tuple(x.shape)}")
    if fplan.lead:
        raise ValueError(f"forest_plan_plain takes one plan, got stacked "
                         f"leading axes {fplan.lead}; slice with "
                         f"ForestPlan.index")
    t, size, j = fplan.t, 1 << fplan.t, fplan.n_tiles
    m = x.shape[1]
    dev = x.device
    xt = x.to(torch.int32).reshape(j, t, m)
    prod = fplan.producer.to(device=dev, dtype=torch.int64)      # (J, 2^T)
    nodes = torch.arange(size, device=dev)
    bits = (nodes[:, None] >> torch.arange(t, device=dev)) & 1   # (2^T, T)
    # direct nodes: the subset sum of their bits (int32 adds, wrapping)
    table = xt.new_zeros((j, size, m))
    for b in range(t):
        table += bits[:, b].to(torch.int32)[None, :, None] * xt[:, b, None]
    table = torch.where((prod == FOREST_DIRECT)[:, :, None], table, 0)
    # level by level, a made node is its parent (v without its producer
    # bit b) plus x[b]: every node is gathered, the level's made nodes kept
    level = bits.sum(1)
    bit = prod.clamp(max=t - 1)
    parent = (nodes[None] ^ (1 << bit))[:, :, None].expand(j, size, m)
    xb = xt.gather(1, bit[:, :, None].expand(j, size, m))
    for lv in range(1, t + 1):
        with scope("level", loop=True):
            made = ((prod < t) & (level == lv)[None])[:, :, None]
            table = torch.where(made, table.gather(1, parent) + xb, table)
    flat = table.reshape(j * size, m)
    rows = fplan.rows.to(device=dev, dtype=torch.int64)          # (J, S, N)
    signs = fplan.signs.to(device=dev, dtype=torch.int64)
    base = torch.arange(j, device=dev)[:, None] * size
    g, n = fplan.groups, fplan.n
    out = torch.zeros((g, n, m), dtype=torch.int64, device=dev)
    for s in range(rows.shape[1]):
        gathered = flat.index_select(0, (rows[:, s] + base).reshape(-1))
        out += signs[s] * gathered.reshape(g, j // g, n, m).sum(
            1, dtype=torch.int64)
    out = out.to(torch.int32).permute(1, 0, 2)                   # (N, G, M)
    return out[:, 0] if g == 1 else out.contiguous()


# ---------------------------------------------------------------------------
# The sparse forest plan: T >= 16, made nodes only
# ---------------------------------------------------------------------------

# SparseForestPlan's array leaves.
SPARSE_DATA_FIELDS = ("codes", "bounds", "rows", "signs")
SPARSE_DIRECT = 1 << 31     # the code of a direct node: this flag | v
SPARSE_MAX_T = 31           # a direct node's bits fit the code's low 31
SPARSE_MAX_SLOT = 32767     # a slot fits int16 (rows, prefix slots)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseForestPlan:
    """A tile-local forest schedule for T >= 16 that keeps only the nodes
    the plan makes.

    A ForestPlan spends a byte on each of a tile's 2^T nodes; at T = 16 a
    tile makes ~8,700 of its 65,536 (N = 1536, W4). Here each tile's made
    nodes (level targets and direct nodes) are renumbered densely in level
    order (by popcount, then value): slots 1..U_j, slot 0 the empty sum.

    ``codes[j, u]`` says how slot ``u`` of tile ``j`` is made: the prefix
    slot ``p`` and the activation bit ``b`` as ``p | b << 16`` (``psum[u]
    = psum[p] + x[j * T + b]``, p in an earlier level), or
    ``SPARSE_DIRECT | v`` for a direct node ``v`` (the subset sum of the
    tile's activations over v's bits); int32, slot 0 and the pad past U_j
    are 0. ``bounds[j, L]`` is one past the last slot of level L (``L =
    1..T``) and ``bounds[j, 0] = 1``: level L is slots ``bounds[j, L - 1]
    .. bounds[j, L] - 1``. ``rows[j, s, n]`` is the slot that output n
    gathers from tile j in plane s, int16, N fastest as in
    :class:`ForestPlan`; ``signs`` as there. The codes' width U (a table's
    rows, slot 0 included) is a multiple of 4, so a tile's codes start on
    16 bytes.

    Leaves may carry leading stacked axes (:meth:`index`). Built by
    :func:`pack_sparse_forest_plan`; run by
    ``kernels/transitive_forest_sparse.py`` and, on any device, by
    :func:`sparse_forest_plain`. Dtype, contiguity and one device are
    checked here, once per plan.
    """
    t: int
    bits: int
    n: int
    k: int
    groups: int
    codes: torch.Tensor         # (J, U) int32
    bounds: torch.Tensor        # (J, T + 1) int32
    rows: torch.Tensor          # (J, S, N) int16
    signs: torch.Tensor         # (S,) int32

    def __post_init__(self):
        for name, dtype in (("codes", torch.int32), ("bounds", torch.int32),
                            ("rows", torch.int16), ("signs", torch.int32)):
            a = getattr(self, name)
            if a.dtype != dtype or not a.is_contiguous():
                raise ValueError(f"SparseForestPlan.{name} must be "
                                 f"contiguous {dtype}, got {a.dtype} "
                                 f"(contiguous: {a.is_contiguous()})")
        devices = {a.device for a in self.leaves().values()}
        if len(devices) != 1:
            raise ValueError(f"SparseForestPlan leaves must share one "
                             f"device, got {sorted(map(str, devices))}")
        if self.codes.shape[-1] % 4:
            raise ValueError(f"SparseForestPlan.codes' width must be a "
                             f"multiple of 4, got {self.codes.shape[-1]}")

    @property
    def n_tiles(self) -> int:
        return self.k // self.t

    @property
    def slots(self) -> int:
        """U: the rows of a tile's table, slot 0 and the pad included."""
        return int(self.codes.shape[-1])

    @property
    def lead(self) -> tuple[int, ...]:
        """Leading stacked axes (``()`` for a single plan)."""
        return tuple(self.signs.shape[:-1])

    def leaves(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in SPARSE_DATA_FIELDS}

    def index(self, i) -> "SparseForestPlan":
        """The plan of stacked entry ``i`` (views, no copies)."""
        return dataclasses.replace(
            self, **{f: a[i] for f, a in self.leaves().items()})

    def nbytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in self.leaves().values())


def _made(dplan: DevicePlan) -> np.ndarray:
    """(..., J, 2^T) bool: the nodes a tile-local DevicePlan makes (level
    targets and real direct targets), node 0 left out."""
    size, r = 1 << dplan.t, dplan.n_tiles << dplan.t
    made = (dplan.level_xsrc.detach().cpu().numpy() != dplan.k).any(-2)
    didx = dplan.direct_idx.detach().cpu().numpy().astype(np.int64)
    for idx in np.ndindex(*dplan.lead):
        real = didx[idx][didx[idx] < r]
        made[idx][real] = True
    made = made.reshape(dplan.lead + (dplan.n_tiles, size))
    made[..., 0] = False
    return made


def sparse_forest_slots(dplan: DevicePlan) -> int:
    """U, the table rows per tile a :class:`SparseForestPlan` of ``dplan``
    would have (slot 0 included, rounded up to 4), counted from the level
    maps and direct targets without packing: what the forest wrappers and
    ``engine_cuda`` pick the route by before they pack."""
    made = _made(dplan)
    u = int(made.sum(-1).max()) + 1 if made.size else 1
    return -(-u // 4) * 4


def _sparse_one(t: int, k: int, level_src, level_xsrc, direct_idx,
                direct_bits, gather_idx) -> tuple[np.ndarray, ...]:
    """(codes (J, U_max + 1) int64, bounds (J, T + 1), rows (J, S, N)) of
    one unstacked plan, its codes not yet padded."""
    producer, nodes = _pack_one(t, k, level_src, level_xsrc, direct_idx,
                                direct_bits, gather_idx)
    j, size = producer.shape
    pop = hasse.levels(t)
    order = hasse.hamming_order(t)               # level order, then value
    made = producer != FOREST_UNUSED
    made[:, 0] = False                           # node 0 is slot 0
    counts = made.sum(1)
    u_max = int(counts.max()) if j else 0
    if u_max > SPARSE_MAX_SLOT:
        raise ValueError(f"a tile makes {u_max} nodes: a slot must fit "
                         f"int16 (<= {SPARSE_MAX_SLOT})")
    codes = np.zeros((j, u_max + 1), np.int64)
    bounds = np.zeros((j, t + 1), np.int64)
    slot_of = np.zeros((j, size), np.int64)
    for jj in range(j):
        seq = order[made[jj, order]]             # made nodes, level order
        slot_of[jj, seq] = np.arange(1, seq.size + 1)
        bounds[jj] = 1 + np.searchsorted(pop[seq], np.arange(t + 1),
                                         side="right")
        p = producer[jj, seq].astype(np.int64)
        chained = p < t
        pre = seq[chained] ^ (1 << p[chained])
        code = np.where(chained, 0, SPARSE_DIRECT | seq)
        code[chained] = slot_of[jj, pre] | (p[chained] << 16)
        codes[jj, 1:seq.size + 1] = code
    rows = np.take_along_axis(slot_of[:, None, :],
                              nodes.reshape(j, -1)[:, None, :], 2)
    return codes, bounds, rows.reshape(nodes.shape)


def complete_forest_plan(t: int, count: int, n: int, bits: int = 4,
                         seed: int = 0) -> ExecutionPlan:
    """A one-tile ExecutionPlan (K = T) that makes the first ``count``
    nonzero nodes of width T in level order (by popcount, then value),
    each from its prefix without its highest bit; its N x S APE gathers
    are drawn from them by ``seed``. Every lower level is complete, so a
    tile of such a plan makes as many nodes as any plan can up to that
    level: it sizes plans whose compact table is too large for shared
    memory or for int16 slots (the two-pass route) without planning a
    weight that large."""
    made = hasse.hamming_order(t)[1:count + 1]
    pop = hasse.levels(t)[made]
    steps = []
    for lv in range(1, int(pop.max()) + 1):
        nd = made[pop == lv]
        top = np.floor(np.log2(nd)).astype(np.int64)       # highest bit
        steps.append(LevelStep(tile=np.zeros_like(nd), node=nd,
                               prefix=nd ^ (1 << top), bit=top))
    rows = np.random.default_rng(seed).choice(made, size=(bits, n, 1))
    empty = np.zeros(0, np.int64)
    return ExecutionPlan(
        t=t, bits=bits, n=n, k=t, rows=rows, si=None, steps=tuple(steps),
        direct_tile=empty, direct_node=empty,
        direct_bits=np.zeros((0, t), np.int64),
        signs=bitslice.plane_signs(bits))


def _first(mask: np.ndarray) -> tuple[int, ...]:
    """The index of a boolean mask's first True entry."""
    flat = int(np.flatnonzero(mask.reshape(-1))[0])
    return tuple(int(i) for i in np.unravel_index(flat, mask.shape))


def _at(name: str, where: tuple[int, ...]) -> str:
    return f"{name}[{', '.join(map(str, where))}]"


def sparse_forest_fault(splan: SparseForestPlan
                        ) -> tuple[str, str, str] | None:
    """The first way a sparse plan breaks what its kernel relies on, as
    ``(path, leaf, message)``, or None: T <= ``SPARSE_MAX_T``; slots fit
    int16; each tile's level bounds start at 1, never fall and stay in
    the table; every chained slot's prefix slot lies in an earlier level
    (or is slot 0) and its bit is below T; every direct slot's node has T
    bits and its own level's popcount; and every gathered slot is made
    (or is slot 0). The kernel leaves slots past a tile's last level
    unwritten, so nothing may read one. Works on stacked plans. The plan
    verifier's ``sparse-forest`` rule reports it as a finding."""
    t = int(splan.t)
    if t > SPARSE_MAX_T:
        return ("t", "t", f"a SparseForestPlan holds T <= {SPARSE_MAX_T} "
                f"(a direct node's bits fit 31), got t={t}")
    codes = splan.codes.detach().cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    bounds = splan.bounds.detach().cpu().numpy().astype(np.int64)
    rows = splan.rows.detach().cpu().numpy().astype(np.int64)
    u = codes.shape[-1]                                   # (..., J, U)
    if u - 1 > SPARSE_MAX_SLOT:
        return ("codes", "codes", f"{u} table rows: a slot must fit int16 "
                f"(<= {SPARSE_MAX_SLOT})")
    bad = np.zeros(bounds.shape, bool)                    # (..., J, T+1)
    bad[..., 0] = bounds[..., 0] != 1
    bad[..., 1:] = np.diff(bounds, axis=-1) < 0
    bad[..., -1] |= bounds[..., -1] > u
    if bad.any():
        w = _first(bad)
        return (_at("bounds", w), "bounds",
                f"{int(bad.sum())} level bound(s) break the table: first "
                f"{_at('bounds', w)} = {int(bounds[w])} (level bounds must "
                f"start at slot 1, never fall and stay inside the {u}-row "
                f"table)")
    slot = np.arange(u)
    # the level of each slot: L where bounds[L - 1] <= slot < bounds[L]
    level = np.zeros(codes.shape, np.int64)
    for lv in range(t + 1):
        level += slot >= bounds[..., lv, None]
    live = (slot >= 1) & (level <= t)
    start = np.take_along_axis(bounds, np.clip(level - 1, 0, t), -1)
    direct = (codes & SPARSE_DIRECT) != 0
    pre, bit = codes & 0xFFFF, (codes >> 16) & 0x7FFF
    node = codes & (SPARSE_DIRECT - 1)
    for bad, what in (
            (live & ~direct & (pre >= start),
             "read a prefix slot that is not in an earlier level"),
            (live & ~direct & (bit >= t),
             f"read an activation bit >= T={t}"),
            (live & direct & ((node >> t != 0)
                              | (hasse.popcount(node) != level)),
             "hold a direct node not of its own level")):
        if bad.any():
            w = _first(bad)
            return (_at("codes", w), "codes",
                    f"{int(bad.sum())} slot(s) {what}: first "
                    f"{_at('codes', w)} = {int(codes[w])} (level "
                    f"{int(level[w])}, which starts at slot "
                    f"{int(start[w])})")
    end = bounds[..., -1][..., None, None]                # (..., J, 1, 1)
    bad = (rows < 0) | (rows >= end)                      # (..., J, S, N)
    if bad.any():
        w = _first(bad)
        return (_at("rows", w), "rows",
                f"{int(bad.sum())} gather(s) read a slot the plan never "
                f"makes: first {_at('rows', w)} = {int(rows[w])} (the "
                f"tile's last made slot is {int(end[w[:-2]][0, 0]) - 1}) "
                f"— the kernel leaves it unwritten")
    return None


def check_sparse_forest_plan(splan: SparseForestPlan) -> None:
    """Raise ``ValueError`` with :func:`sparse_forest_fault`'s message
    unless the sparse plan holds what its kernel relies on."""
    fault = sparse_forest_fault(splan)
    if fault is not None:
        raise ValueError(fault[2])


def pack_sparse_forest_plan(dplan: DevicePlan, *, device=None
                            ) -> SparseForestPlan:
    """Repack a tile-local :class:`DevicePlan` as a
    :class:`SparseForestPlan`, for any T up to ``SPARSE_MAX_T`` (the
    route of T >= 16, where a ForestPlan's gather no longer fits int16).

    Runs :func:`pack_forest_plan`'s checks on the dense plan (edges add
    one bit to a prefix one level down, no node made twice, direct bits
    the node's own, nothing reads a node never made), numbers each tile's
    made nodes in level order, pads U to the largest tile's (over stacked
    entries too) and to a multiple of 4, and checks the result with
    :func:`check_sparse_forest_plan`. The leaves are made here, contiguous
    on ``device`` (default: the plan's). Counts its calls in
    ``pack_sparse_forest_plan.calls``."""
    pack_sparse_forest_plan.calls += 1
    splan = _pack_sparse_forest(dplan)
    check_sparse_forest_plan(splan)                 # on the host
    device = dplan.signs.device if device is None else device
    return dataclasses.replace(splan, **{
        f: a.to(device) for f, a in splan.leaves().items()})


def _pack_sparse_forest(dplan: DevicePlan) -> SparseForestPlan:
    """:func:`pack_sparse_forest_plan` uncounted and unchecked, on the
    host (the plan verifier's ``plan-forest-agreement`` packs with it and
    compares leaves; it does not verify the plan again)."""
    if not dplan.tile_local:
        raise ValueError("pack_sparse_forest_plan needs a tile-local plan "
                         "(compile it with compile_plan)")
    if dplan.t > SPARSE_MAX_T:
        raise ValueError(f"a direct node's bits fit 31: T <= "
                         f"{SPARSE_MAX_T}, got T={dplan.t}")
    leaves = {f: a.detach().cpu().numpy() for f, a in dplan.leaves().items()}
    for name, a in leaves.items():
        if a.dtype != np.int32:
            raise ValueError(f"plan leaf {name} must be int32, got "
                             f"{a.dtype}")
    lead = dplan.lead
    packed = [_sparse_one(dplan.t, dplan.k, *(leaves[f][idx] for f in (
        "level_src", "level_xsrc", "direct_idx", "direct_bits",
        "gather_idx"))) for idx in np.ndindex(*lead)]
    u = -(-max(c.shape[1] for c, _, _ in packed) // 4) * 4
    codes = np.stack([np.pad(c, ((0, 0), (0, u - c.shape[1])))
                      for c, _, _ in packed])
    codes = (codes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    bounds = np.stack([b for _, b, _ in packed]).astype(np.int32)
    rows = np.stack([r for _, _, r in packed]).astype(np.int16)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.reshape(lead + a.shape[1:])))
    return SparseForestPlan(
        t=dplan.t, bits=dplan.bits, n=dplan.n, k=dplan.k, groups=dplan.groups,
        codes=as_t(codes), bounds=as_t(bounds), rows=as_t(rows),
        signs=torch.from_numpy(leaves["signs"].copy()))


pack_sparse_forest_plan.calls = 0


def sparse_forest_plain(splan: SparseForestPlan, x: torch.Tensor
                        ) -> torch.Tensor:
    """Execute a :class:`SparseForestPlan` against activations ``x`` (K, M)
    in plain torch, level by level over the slots, on any device.

    Returns int32 (N, M) ungrouped, (N, G, M) grouped, bit-exact with
    :func:`run_device` on the plan it was packed from: the sparse forest
    kernel's plain version. The table is int32 (wrapping adds like the
    reference's); the APE sums run in int64 and are cast back, which is
    congruent mod 2^32."""
    if x.ndim != 2 or x.shape[0] != splan.k:
        raise ValueError(f"x must be (K={splan.k}, M), got {tuple(x.shape)}")
    if splan.lead:
        raise ValueError(f"sparse_forest_plain takes one plan, got stacked "
                         f"leading axes {splan.lead}; slice with "
                         f"SparseForestPlan.index")
    t, u, j = splan.t, splan.slots, splan.n_tiles
    m = x.shape[1]
    dev = x.device
    xt = x.to(torch.int32).reshape(j, t, m)
    codes = splan.codes.to(device=dev, dtype=torch.int64) & 0xFFFFFFFF
    bounds = splan.bounds.to(device=dev, dtype=torch.int64)      # (J, T+1)
    slot = torch.arange(u, device=dev)
    level = (slot[None, :, None] >= bounds[:, None, :]).sum(-1)  # (J, U)
    direct = (codes & SPARSE_DIRECT) != 0
    tbits = torch.arange(t, device=dev)
    table = xt.new_zeros((j, u, m))
    for lv in range(1, t + 1):
        on = (level == lv) & (slot >= 1)[None]
        jj, uu = torch.nonzero(on & ~direct, as_tuple=True)
        code = codes[jj, uu]
        table[jj, uu] = table[jj, code & 0xFFFF] + xt[jj, (code >> 16)
                                                       & 0x7FFF]
        jd, ud = torch.nonzero(on & direct, as_tuple=True)
        vbits = (codes[jd, ud, None] >> tbits) & 1                # (D, T)
        table[jd, ud] = (vbits.to(torch.int32)[:, :, None]
                         * xt[jd]).sum(1, dtype=torch.int32)
    flat = table.reshape(j * u, m)
    rows = splan.rows.to(device=dev, dtype=torch.int64)          # (J, S, N)
    base = torch.arange(j, device=dev)[:, None] * u
    g, n = splan.groups, splan.n
    out = torch.zeros((g, n, m), dtype=torch.int64, device=dev)
    for s in range(rows.shape[1]):
        gathered = flat.index_select(0, (rows[:, s] + base).reshape(-1))
        out += int(splan.signs[s]) * gathered.reshape(g, j // g, n, m).sum(
            1, dtype=torch.int64)
    out = out.to(torch.int32).permute(1, 0, 2)                   # (N, G, M)
    return out[:, 0] if g == 1 else out.contiguous()
