"""Time B4, the group-dequant W4A8 GEMM, on the card: the entry a user
calls beside another checkout's, the rings and splits ``launch_plan``
weighs, and copies of its source with a part taken out.

    python src/repro_torch/launch/bench_w4a8.py [--src DIR] [--sweep]
        [--ablate] [--out FILE]

Shapes (N, K, group) x M: smollm-135m's up/gate (1536, 576, 64) and down
(576, 1536, 128) linears and llama1_7b's gate/up (11008, 4096, 128) and
down (4096, 11008, 128), each at M = 4 (decode) and M = 512 (prefill);
inputs from a seed (int8 activations, int4 weights in int8, scales in
[0.5, 2)). Each instance's own device time beside the other's, the
``torch._int_mm`` line and the bound are ``chip_smoke.py``'s B4 phase.

With no flag: ``w4a8_gemm_cuda`` (the wrapper ``kernels/ops.py::
w4a8_gemm`` calls) from the package under ``--src`` (default: this
checkout's ``src``), so that a parent checkout unpacked with ``git
archive`` under the gitignored ``build/`` is timed by the same code: run
it once per checkout, in turns (parent, change, change, parent), in one
call on one card. Per shape: the profiler's device us per call of every
device op the call runs (the L2 flushed before each call; read through
``launch/device_events.py``) and the kernels' names, the event-timed ms
per call (L2 flushed before each), and the host us per call (wall clock
over 200 calls queued back to back, before the device is waited for:
what the wrapper costs the host).

``--sweep`` (this checkout only) times, at each shape, every ring
(stages x boxes a stage) and K split of ``w4a8_wgmma`` that fits beside
the one ``launch_plan`` picks, through the uncounted ``w4a8_gemm.
_launch``: the profiler's device us of the kernel alone, L2 flushed.
``--ablate`` builds copies of ``csrc/w4a8_gemm.cu`` into
``build/ablate/`` with one part changed and times them beside the kernel
in turns (device us): ``no_epilogue`` drops the f32 group epilogue (its
results are wrong, and are not meant to be right); ``magic`` converts the
group dots by a bit trick (the bits of 1.5 * 2^23 + v, less 1.5 * 2^23:
an integer add and a float add, exact here too) instead of the
conversion instruction. The last line is a JSON object of the numbers;
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

SHAPES = [(1536, 576, 64), (576, 1536, 128), (11008, 4096, 128),
          (4096, 11008, 128)]
MS = (4, 512)
EPILOGUE = ("    acc[r] = __fadd_rn(acc[r], __fmul_rn(to_f32(d[r]), "
            "(r & 2) ? s1 : s0));\n")
ABLATIONS = {
    "no_epilogue": ((EPILOGUE, "    acc[r] = acc[r];\n"),),
    "magic": (("  return __int2float_rn(v);",
               "  return __fsub_rn(__int_as_float(v + 0x4B400000), "
               "12582912.0f);"),),
}


def inputs(torch, m, n, k, group, seed=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-8, 8, (n, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    sx = torch.rand((m,), generator=gen, device="cuda") * 1.5 + 0.5
    sg = torch.rand((n, k // group), generator=gen, device="cuda") * 1.5 + 0.5
    return x, sx, w, sg


def device_us(fn, flush, name="", iters=20):
    """Device us per call of the device ops whose name holds ``name``
    (every op but the flush's fill by default), the L2 flushed before each
    call, and the names of those ops."""
    from repro_torch.launch.device_events import device_events

    def call():
        flush.zero_()
        fn()
    events = [e for e in device_events(call, iters)
              if (name in e.key if name else "FillFunctor" not in e.key)]
    return (sum(e.self_device_time_total for e in events) / iters,
            sorted({e.key for e in events}))


def event_ms(torch, fn, flush, iters=20):
    """Mean ms per call from CUDA events around each call, the L2 flushed
    before each, after three calls."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def host_us(torch, fn, calls=200):
    """Host us per call: wall clock over ``calls`` calls queued back to
    back, read before the device is waited for."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def _short(name):
    """``w4a8_wgmma<8, 1, 4>`` of the profiler's full kernel name."""
    return name.split("(")[-2].split("::")[-1] if "(" in name else name


def time_wrapper(torch, flush):
    """``w4a8_gemm_cuda`` of the package on ``sys.path`` at every shape."""
    from repro_torch.kernels.w4a8_gemm import w4a8_gemm_cuda
    rows = []
    for n, k, group in SHAPES:
        for m in MS:
            x, sx, w, sg = inputs(torch, m, n, k, group)
            sx = sx.reshape(m, 1)

            def call():
                w4a8_gemm_cuda(x, sx, w, sg, group=group)
            us, names = device_us(call, flush)
            row = {"shape": f"N={n} K={k} group={group} M={m}",
                   "device_us": us, "kernels": names,
                   "ms": event_ms(torch, call, flush),
                   "host_us": host_us(torch, call)}
            rows.append(row)
            print(f"[B4 wrapper] {row['shape']}: device {us:.2f} us "
                  f"({', '.join(_short(nm) for nm in names)}) | "
                  f"event {row['ms']:.4f} ms | host {row['host_us']:.2f} "
                  f"us/call", flush=True)
            del x, w, sg
            torch.cuda.empty_cache()
    return rows


def sweep(torch, W, flush):
    """Every ring and split that fits, at each shape, beside the pick."""
    lib = W._library()
    out_rows = []
    for n, k, group in SHAPES:
        for m in MS:
            x, sx, w, sg = inputs(torch, m, n, k, group)
            out = torch.empty((m, n), device="cuda")
            picked = W.launch_plan(m, n, k, group, x.data_ptr(),
                                   w.data_ptr())

            def kus(plan):
                return device_us(lambda: W._launch(
                    lib, x, sx, w, sg, out, group, plan), flush,
                    "w4a8_wgmma", iters=10)[0]
            results = []
            for kb in (1, 2, 4):
                if 4 * kb % (group // W.KSTEP):
                    continue
                for ns in (2, 3, 4, 6, 8):
                    smem = W.wgmma_smem(picked.bt, picked.wgs, ns, kb)
                    if smem > W.SMEM_LIMIT:
                        continue
                    for split in range(1, min(W.MAX_SPLIT, k // group) + 1):
                        if split > 1 and W.tile_bytes(
                                picked.bt, picked.wgs) > smem - 1024 - 16 * ns:
                            continue
                        plan = W.with_split(picked, split)._replace(
                            ns=ns, kb=kb, smem=smem)
                        results.append((kus(plan), ns, kb, split))
            results.sort()
            mine = kus(picked)
            shape = f"N={n} K={k} group={group} M={m}"
            print(f"[sweep] {shape}: launch_plan ns={picked.ns} kb="
                  f"{picked.kb} split={picked.split} {mine:.2f} us; best "
                  "(ns/kb/split): " + "; ".join(
                      f"{a}/{b}/{c} {t:.2f}" for t, a, b, c in results[:6])
                  + f"; worst {results[-1][0]:.2f} us (device)", flush=True)
            out_rows.append({"shape": shape, "picked": [picked.ns, picked.kb,
                                                        picked.split, mine],
                             "all": results})
            del x, w, sg, out
            torch.cuda.empty_cache()
    return out_rows


def _ablated(build, name, edits):
    """Build a copy of the source with ``edits`` applied; its library."""
    src = (build.CSRC / "w4a8_gemm.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablation {name}: its edit no longer applies")
        src = src.replace(old, new)
    out = build.BUILD_DIR.parent / "ablate"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"w4a8_{name}.cu"
    cu.write_text(src)
    lib = out / f"libw4a8_{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    return str(lib)


def ablate(torch, W, build, flush):
    """The kernel beside its ablated copies, device us, in turns."""
    libs = {"w4a8_wgmma": W._library()}
    for name, edits in ABLATIONS.items():
        lib = ctypes.CDLL(_ablated(build, name, edits))
        lib.w4a8_wgmma_launch.argtypes = \
            libs["w4a8_wgmma"].w4a8_wgmma_launch.argtypes
        lib.w4a8_gemm_error.argtypes = [ctypes.c_int]
        lib.w4a8_gemm_error.restype = ctypes.c_char_p
        libs[name] = lib
    rows = []
    for n, k, group in SHAPES:
        for m in MS:
            x, sx, w, sg = inputs(torch, m, n, k, group)
            out = torch.empty((m, n), device="cuda")
            plan = W.launch_plan(m, n, k, group, x.data_ptr(), w.data_ptr())
            times = {}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    times.setdefault(name, []).append(device_us(
                        lambda: W._launch(libs[name], x, sx, w, sg, out,
                                          group, plan), flush,
                        "w4a8_wgmma")[0])
            shape = f"N={n} K={k} group={group} M={m}"
            print(f"[ablate] {shape}: " + "; ".join(
                f"{name} " + ", ".join(f"{v:.2f}" for v in t) + " us"
                for name, t in times.items()), flush=True)
            rows.append({"shape": shape, "device_us": times})
            del x, w, sg, out
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(here)),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("bench_w4a8: needs a CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build
    build.build_all(("w4a8_gemm",))
    print(f"[B4] timing {os.path.dirname(repro_torch.__file__)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    result = {"src": os.path.abspath(args.src),
              "device": torch.cuda.get_device_name(0)}
    if args.sweep or args.ablate:
        from repro_torch.kernels import w4a8_gemm as W
        if args.sweep:
            result["sweep"] = sweep(torch, W, flush)
        if args.ablate:
            result["ablate"] = ablate(torch, W, build, flush)
    else:
        result["wrapper"] = time_wrapper(torch, flush)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
