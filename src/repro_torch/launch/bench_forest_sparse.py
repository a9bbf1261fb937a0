"""Time B1 at T >= 16 (``forest_sparse``) on the card: over its tilings,
beside copies of its source with a part taken out, and beside the
two-pass kernel.

    python src/repro_torch/launch/bench_forest_sparse.py [--out FILE]

Plans one ``engine_cuda`` linear at T = 16, N = 1536, K = 64 (W4,
ungrouped, weights from a seed; K cut from smollm-135m's 576 because
planning at T = 16 takes ~25 s per 1536 x 64 on the host), packs it into
a SparseForestPlan and, at M = 4 and M = 64, prints the profiler's device
us per call (the kernel alone) of:

  * ``forest_sparse`` through its C entry at the tiling
    ``sparse_tiling`` picks and at every other bn (64 ... 512) with the
    same bm, nbuf and cluster, each held exact to ``run_device``;
  * ablations, copies of ``csrc/transitive_forest_sparse.cu`` built into
    ``build/ablate/`` with one part taken out (their results are not
    exact, and are not meant to be): ``no_build`` skips the T levels,
    ``no_level_barrier`` drops the block barrier after each level;
  * the two-pass kernel (``forest_dense_tiles`` + ``forest_dense_ape``)
    on the same DevicePlan and x.

Each variant is timed twice, in turns (forward, then backward), in one
process on one card. The last line is a JSON object of the numbers;
``--out`` also writes it to a file. CUDA only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ABLATIONS = {
    "no_build": ("    for (int L = 1; L <= T; ++L) {\n      const int lo",
                 "    for (int L = 1; L <= 0; ++L) {\n      const int lo"),
    "no_level_barrier": (
        "store(table + (size_t)(i0 + u * SNT) * BM);\n      }\n"
        "      __syncthreads();",
        "store(table + (size_t)(i0 + u * SNT) * BM);\n      }\n"),
}


def device_us(fn, iters=20):
    """Device us per call of ``fn`` from the profiler, read through
    ``launch/device_events.py`` (only a read that holds every launch)."""
    from repro_torch.launch.device_events import device_events
    return sum(e.self_device_time_total
               for e in device_events(fn, iters)) / iters


def _ablated(build, name, edit):
    """Build a copy of the source with ``edit`` applied; its library."""
    src = (build.CSRC / "transitive_forest_sparse.cu").read_text()
    old, new = edit
    if old not in src:
        raise RuntimeError(f"ablation {name}: its edit no longer applies")
    out = build.BUILD_DIR.parent / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"{name}.cu"
    cu.write_text(src.replace(old, new))
    lib = out / f"lib{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return str(lib)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    import numpy as np
    import torch
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan,
                                         pack_sparse_forest_plan, run_device)
    from repro_torch.kernels import build
    from repro_torch.kernels import transitive_forest_sparse as tfs
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    if not torch.cuda.is_available():
        print("bench_forest_sparse: needs a CUDA device", file=sys.stderr)
        return 2
    build.build_all(("transitive_forest_sparse", "transitive_forest_dense"))
    libs = {"forest_sparse": tfs._library()}
    for name, edit in ABLATIONS.items():
        libs[name] = ctypes.CDLL(_ablated(build, name, edit))
        libs[name].transitive_forest_sparse_launch.argtypes = \
            libs["forest_sparse"].transitive_forest_sparse_launch.argtypes
    t0 = time.perf_counter()
    w = np.random.default_rng(16).integers(-8, 8, size=(1536, 64))
    dplan = compile_plan(BatchedTransitiveEngine(4, 16).plan(w),
                         device="cuda")
    sp = pack_sparse_forest_plan(dplan)
    print(f"{torch.cuda.get_device_name(0)} | T=16 N=1536 K=64 W4: planned "
          f"in {time.perf_counter() - t0:.1f}s, U={sp.slots}, "
          f"SparseForestPlan {sp.nbytes()} B, DevicePlan {dplan.nbytes()} B",
          flush=True)
    result = {"device": torch.cuda.get_device_name(0), "slots": sp.slots}
    for m in (4, 64):
        gen = torch.Generator(device="cuda").manual_seed(m)
        qx = torch.randint(-128, 128, (m, 64), generator=gen, device="cuda",
                           dtype=torch.int8)
        x = qx.T.to(torch.int32).contiguous()
        want = run_device(dplan, x).T
        out = torch.empty((m, 1, 1536), dtype=torch.int32, device="cuda")
        tl = tfs.sparse_tiling(16, 4, sp.slots, 1536, m, 4)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib, bn):
            err = lib.transitive_forest_sparse_launch(
                qx.data_ptr(), 1, 64, m, sp.codes.data_ptr(),
                sp.bounds.data_ptr(), sp.rows.data_ptr(),
                sp.signs.data_ptr(), 16, 4, 1536, 1, sp.slots, tl.bm,
                tl.nbuf, bn, tl.cluster, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        variants = [(f"forest_sparse bn={bn}" + (" (picked)" if bn == tl.bn
                                                 else ""),
                     libs["forest_sparse"], bn) for bn in (512, 256, 128, 64)]
        variants += [(name, libs[name], tl.bn) for name in ABLATIONS]
        times = {}
        for order in (variants, variants[::-1]):
            for name, lib, bn in order:
                launch(lib, bn)
                torch.cuda.synchronize()
                exact = bool(torch.equal(out[:, 0], want))
                us = device_us(lambda: launch(lib, bn))
                times.setdefault(name, []).append(us)
                print(f"M={m} {name}: {us:.2f} us (exact: {exact})",
                      flush=True)
        two = device_us(lambda: transitive_forest_dense(dplan, x), iters=3)
        times["two-pass kernel"] = [two]
        print(f"M={m} two-pass kernel on the DevicePlan: {two:.2f} us",
              flush=True)
        result[f"M={m}"] = times
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
