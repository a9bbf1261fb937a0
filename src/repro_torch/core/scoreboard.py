"""Faithful Scoreboard (paper Sec. 3): Alg. 1 forward, Alg. 2 backward, forest.

The Scoreboard turns an observed multiset of T-bit TransRows into an
execution plan over the Hasse graph:

  1. Hamming-order sort (Sec. 3.1) — we traverse nodes level-by-level.
  2. Forward pass (Alg. 1)  — propagate candidate prefixes with distances
     1..4 down the covering edges; present nodes reset the distance.
  3. Backward pass (Alg. 2) — nodes with Count>0 and Distance>1 pick the
     first relay prefix from the smallest-distance prefix bitmap and
     materialise the relay as a bridge (Count := 1, a "TR" node).
  4. Balanced forest (Sec. 2.4/Fig. 5-5) — distance-1 nodes choose, among
     their candidate prefixes, the lane with the least workload; lanes are
     rooted at the T level-1 nodes.

Everything is vectorised across an arbitrary leading ``tiles`` axis so that
whole-tensor (static) and per-sub-tile (dynamic) scoreboards share one
implementation. Plain numpy — this is the *model* of the hardware unit; the
GPU execution path lives in kernels/
"""
from __future__ import annotations

import dataclasses
import numpy as np

from repro_torch.core import hasse

__all__ = ["ScoreboardInfo", "dynamic_scoreboard", "static_scoreboard",
           "static_tile_stats", "MAX_DISTANCE", "INF"]

MAX_DISTANCE = 4      # paper: prefixes with distance < 4; >=4 are outliers
INF = 1 << 30


@dataclasses.dataclass
class ScoreboardInfo:
    """Scoreboard Information (SI) for a batch of tiles (Fig. 5 step 6)."""
    t: int                      # TransRow width T
    n_rows: int                 # TransRows per tile
    counts: np.ndarray          # (tiles, 2^T) int32 — original row counts
    exec_counts: np.ndarray     # (tiles, 2^T) int32 — counts after bridging
    bridge: np.ndarray          # (tiles, 2^T) bool  — TR nodes (materialised)
    distance: np.ndarray        # (tiles, 2^T) int32 — final distance (INF = none)
    prefix: np.ndarray          # (tiles, 2^T) int32 — selected prefix node (-1: root/none)
    lane: np.ndarray            # (tiles, 2^T) int32 — lane id (-1: unassigned)
    outlier: np.ndarray         # (tiles, 2^T) bool  — present, distance >= MAX_DISTANCE
    wl_ppe: np.ndarray          # (tiles, T) int64   — per-lane PPE ops
    wl_ape: np.ndarray          # (tiles, T) int64   — per-lane APE ops

    @property
    def tiles(self) -> int:
        return self.counts.shape[0]

    @property
    def present(self) -> np.ndarray:
        p = self.counts > 0
        p[:, 0] = False
        return p

    @property
    def executed(self) -> np.ndarray:
        """Nodes that occupy a PPE slot (present or bridge, excl. node 0)."""
        e = (self.exec_counts > 0) & ~self.outlier
        e[:, 0] = False
        return e


# De Bruijn multiply-shift lowest-set-bit: exact in integer arithmetic, so
# prefix selection cannot drift with float log2 rounding at larger T.
_DEBRUIJN32 = np.uint32(0x077CB531)
_DEBRUIJN_IDX = np.empty(32, dtype=np.int64)
for _i in range(32):
    _DEBRUIJN_IDX[(((1 << _i) * 0x077CB531) & 0xFFFFFFFF) >> 27] = _i
del _i


def _first_set_bit(bm: np.ndarray) -> np.ndarray:
    """Lowest set bit index of each nonzero entry ("first available" prefix)."""
    b32 = bm.astype(np.uint32)
    lsb = b32 & (~b32 + np.uint32(1))       # isolate lowest set bit
    idx = _DEBRUIJN_IDX[(lsb * _DEBRUIJN32) >> np.uint32(27)]
    return np.where(b32 != 0, idx, -1)


def _node_counts(rows: np.ndarray, t: int) -> np.ndarray:
    """Per-tile histogram over 2^T node values. rows: (tiles, n) uint."""
    tiles, n = rows.shape
    size = 1 << t
    offs = (np.arange(tiles, dtype=np.int64)[:, None] * size)
    flat = np.bincount((rows.astype(np.int64) + offs).ravel(),
                       minlength=tiles * size)
    return flat.reshape(tiles, size).astype(np.int32)


def dynamic_scoreboard(rows: np.ndarray, t: int,
                       max_distance: int = MAX_DISTANCE) -> ScoreboardInfo:
    """Build per-tile Scoreboard Information (the dynamic SI, Sec. 3.4).

    Args:
      rows: (tiles, n) uint array of TransRow values in [0, 2^T).
      t: TransRow width.
      max_distance: paper's outlier threshold (4).

    Returns: ScoreboardInfo batched over tiles.
    """
    rows = np.atleast_2d(np.asarray(rows))
    tiles, n_rows = rows.shape
    size = 1 << t
    counts = _node_counts(rows, t)
    levels = hasse.levels(t)
    order = hasse.hamming_order(t)
    cov_pre = hasse.covering_prefixes(t)    # (2^T, T)
    cov_suf = hasse.covering_suffixes(t)    # (2^T, T)

    # Prefix bitmaps: PB[tile, node, d-1] is a T-bit mask; bit i set means
    # "node with bit i cleared relays a path of distance d" (Fig. 6).
    pb = np.zeros((tiles, size, max_distance), dtype=np.uint32)
    dist = np.full((tiles, size), INF, dtype=np.int64)
    dist[:, 0] = 0

    # ---- Forward pass (Alg. 1) ------------------------------------------
    for idx in order:
        d = dist[:, idx]
        # Line 7: nodes at distance >= max_d (and not root) neither relay
        # nor receive a path — they are outliers.
        alive = (d < max_distance) | (idx == 0)
        if not alive.any():
            continue
        present = counts[:, idx] > 0
        eff = np.where(present | (idx == 0), 0, d)        # Line 8
        sufs = cov_suf[idx]
        set_bits = np.nonzero(sufs >= 0)[0]
        for b in set_bits:                                 # Lines 9-10
            sfx = int(sufs[b])
            # relayed distance eff+1 must fit a bitmap slot (<= max_d)
            for dval in range(1, max_distance + 1):
                m = alive & (eff == dval - 1)
                if not m.any():
                    continue
                pb[m, sfx, dval - 1] |= np.uint32(1 << b)
                dist[m, sfx] = np.minimum(dist[m, sfx], dval)   # Line 13

    outlier = (counts > 0) & (dist >= max_distance)
    outlier[:, 0] = False

    # ---- Backward pass (Alg. 2) -----------------------------------------
    exec_counts = counts.copy()
    bridge = np.zeros((tiles, size), dtype=bool)
    prefix = np.full((tiles, size), -1, dtype=np.int64)
    tidx = np.arange(tiles)
    for idx in order[::-1]:
        if idx == 0:
            continue
        d = dist[:, idx]
        need = (exec_counts[:, idx] > 0) & (d > 1) & (d < max_distance)
        if not need.any():
            continue
        sel = np.nonzero(need)[0]
        bm = pb[sel, idx, d[sel] - 1]                      # Line 7: first PB
        b = _first_set_bit(bm)
        ok = b >= 0
        sel, b = sel[ok], b[ok]
        relay = int(idx) & ~(1 << b)                       # 1->0 bit flip
        newly = exec_counts[sel, relay] == 0
        bridge[sel[newly], relay[newly]] = True            # TR node
        exec_counts[sel[newly], relay[newly]] = 1          # Count := 1 (L.8-10)
        prefix[sel, idx] = relay
    del tidx

    # ---- Balanced forest (lane assignment) -------------------------------
    lane = np.full((tiles, size), -1, dtype=np.int64)
    wl_ppe = np.zeros((tiles, t), dtype=np.int64)
    wl_ape = np.zeros((tiles, t), dtype=np.int64)
    for idx in order:
        if idx == 0:
            continue
        exe = (exec_counts[:, idx] > 0) & ~outlier[:, idx]
        if not exe.any():
            continue
        cnt = counts[:, idx]
        if levels[idx] == 1:
            ln = int(np.log2(idx))                         # lanes root at level 1
            lane[exe, idx] = ln
            prefix[exe, idx] = 0
            wl_ppe[exe, ln] += 1
            wl_ape[exe, ln] += cnt[exe]
            continue
        # Nodes with a backward-selected relay inherit its lane.
        pre = prefix[:, idx]
        has_pre = exe & (pre >= 0)
        if has_pre.any():
            s = np.nonzero(has_pre)[0]
            lane[s, idx] = lane[s, pre[s]]
        # Distance-1 nodes choose the least-loaded candidate lane (Fig. 5-5).
        free = exe & (pre < 0) & (dist[:, idx] == 1)
        if free.any():
            s = np.nonzero(free)[0]
            bm = pb[s, idx, 0]
            cands = cov_pre[idx]
            cand_bits = np.nonzero(cands >= 0)[0]
            lanes_c = np.full((len(s), len(cand_bits)), -1, dtype=np.int64)
            loads_c = np.full((len(s), len(cand_bits)), np.iinfo(np.int64).max,
                              dtype=np.int64)
            for j, b in enumerate(cand_bits):
                valid = (bm & (1 << b)) > 0
                cnode = int(cands[b])
                if cnode == 0:
                    cl = np.full(len(s), int(np.log2(idx & (1 << b))), dtype=np.int64)
                else:
                    cl = lane[s, cnode]
                valid &= cl >= 0
                lanes_c[valid, j] = cl[valid]
                loads_c[valid, j] = wl_ppe[s, cl][valid]
            pick = np.argmin(loads_c, axis=1)
            chosen_lane = lanes_c[np.arange(len(s)), pick]
            chosen_node = cov_pre[idx][cand_bits[pick]]
            good = chosen_lane >= 0
            lane[s[good], idx] = chosen_lane[good]
            prefix[s[good], idx] = chosen_node[good]
        # Update workloads for every executed instance of this node.
        upd = np.nonzero(exe & (lane[:, idx] >= 0))[0]
        ln = lane[upd, idx]
        np.add.at(wl_ppe, (upd, ln), 1)
        np.add.at(wl_ape, (upd, ln), cnt[upd])

    return ScoreboardInfo(t=t, n_rows=n_rows, counts=counts,
                          exec_counts=exec_counts, bridge=bridge,
                          distance=dist.astype(np.int64), prefix=prefix,
                          lane=lane, outlier=outlier,
                          wl_ppe=wl_ppe, wl_ape=wl_ape)


def static_scoreboard(all_rows: np.ndarray, t: int,
                      max_distance: int = MAX_DISTANCE) -> ScoreboardInfo:
    """Tensor-level static SI (Sec. 3.3): one scoreboard over all TransRows."""
    return dynamic_scoreboard(np.asarray(all_rows).reshape(1, -1), t,
                              max_distance)


def _chains(si: ScoreboardInfo) -> list[np.ndarray]:
    """Per-node global prefix chains node -> ... -> 0 from a static SI."""
    assert si.tiles == 1
    size = 1 << si.t
    prefix = si.prefix[0]
    chains: list[np.ndarray] = []
    for idx in range(size):
        chain = []
        cur = idx
        seen = 0
        while cur > 0 and prefix[cur] >= 0 and seen <= si.t:
            cur = int(prefix[cur])
            chain.append(cur)
            seen += 1
        chains.append(np.asarray(chain, dtype=np.int64))
    return chains


def static_tile_stats(si: ScoreboardInfo, rows: np.ndarray) -> dict:
    """Execute tiles against a *static* SI and count ops incl. SI misses.

    A node's prefix chain is fixed by the static SI. Inside one tile, we walk
    each present node's chain upward until we reach a node already computed
    in this tile (or the root); every hop is one PPE add, and chain nodes
    crossed become tile-local bridges (reusable). A prefix absent from the
    tile is the paper's **SI miss** (Sec. 3.3) — it costs the extra hops.

    Returns dict of per-tile op counts (ppe, ape, dense, bit) as int64 arrays.
    """
    rows = np.atleast_2d(np.asarray(rows))
    t = si.t
    size = 1 << t
    tiles, n_rows = rows.shape
    counts = _node_counts(rows, t)
    order = hasse.hamming_order(t)
    chains = _chains(si)
    levels = hasse.levels(t)
    static_exec = si.exec_counts[0] > 0

    computed = np.zeros((tiles, size), dtype=bool)
    ppe = np.zeros(tiles, dtype=np.int64)
    for idx in order:
        if idx == 0:
            continue
        here = counts[:, idx] > 0
        if not here.any():
            continue
        if si.outlier[0, idx] or not static_exec[idx]:
            # Static SI has no path for this node: direct accumulation.
            ppe[here] += int(levels[idx])
            computed[here, idx] = True
            continue
        chain = chains[idx]
        # hops[tile] = 1 + index of first chain node computed in this tile.
        hops = np.full(tiles, len(chain) + 1, dtype=np.int64)
        reached = np.zeros(tiles, dtype=bool)
        for j, cnode in enumerate(chain):
            hit = ~reached & (computed[:, cnode] | (cnode == 0))
            hops[hit] = j + 1
            reached |= hit
            # chain nodes crossed before the hit become tile-local bridges
        # Without a computed ancestor the chain ends at root (cnode 0 always
        # terminates chains of the static forest); anything else is direct.
        no_hit = here & ~reached
        if no_hit.any():
            ppe[no_hit] += int(levels[idx])
            computed[no_hit, idx] = True
        ok = here & reached
        ppe[ok] += hops[ok]
        computed[ok, idx] = True
        # mark crossed chain nodes computed (they were materialised)
        for j, cnode in enumerate(chain):
            crossed = ok & (hops > j + 1)
            if cnode != 0 and crossed.any():
                computed[crossed, cnode] = True

    nonzero_rows = n_rows - counts[:, 0]
    dense = np.full(tiles, n_rows * t, dtype=np.int64)
    bit = (counts.astype(np.int64) * levels[None, :]).sum(-1)
    return {"ppe": ppe, "ape": nonzero_rows.astype(np.int64),
            "dense": dense, "bit": bit}
