"""Time B5, the linear-recurrence kernel, on the card; beside another
checkout's, or over tilings.

    python src/repro_torch/launch/bench_rg_lru.py [--src DIR] [--sweep]

Times ``repro_torch.kernels.rg_lru.rg_lru_cuda`` from the package under
``--src`` (default: this checkout's ``src``), so that a parent checkout
unpacked with ``git archive`` under the gitignored ``build/`` is timed by
the same code: run it once per checkout, in turns (parent, change,
change, parent), in one call on one card. Shapes: recurrentgemma-9b's
width D = 4096 at B = 4, S = 2048 in the four (x, a) dtype pairs that
``chip_smoke.py`` times, and at B = 1, S = 65,536 in float32 (the
``long_500k`` configuration's B = 1 with S cut from 524,288 so that the
plain version's S-step loop, which ``chip_smoke.py`` holds the kernel to,
fits its time). For each: the profiler's device us per call (all device
ops, and the ``rg_lru`` kernels alone) and their names, the event-timed
ms per call (L2 flushed before each), and the bytes bound on an H100
SXM. The last line is a JSON object of the same numbers.

``--sweep`` (this checkout only) times every (dt, st, ns) of the ring
instance that fits a block's shared memory (``SWEEP``: D = 4096 at B = 4
and B = 1 in float32 and bfloat16, B = 2 and B = 16 in float32), through
the uncounted ``rg_lru._launch``, with CUDA events around each of 10
launches, beside the tiling ``launch_plan`` picks. ``--out`` also writes
the JSON result to a file. CUDA only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
SWEEP = [(4, 2048, 4096, "float32", "float32"),
         (4, 2048, 4096, "bfloat16", "bfloat16"),
         (1, 65536, 4096, "float32", "float32"),
         (1, 65536, 4096, "bfloat16", "bfloat16"),
         (2, 8192, 4096, "float32", "float32"),
         (16, 512, 4096, "float32", "float32")]
SHAPES = [(4, 2048, 4096, "float32", "float32"),
          (4, 2048, 4096, "bfloat16", "bfloat16"),
          (4, 2048, 4096, "float16", "float16"),
          (4, 2048, 4096, "float32", "bfloat16"),
          (1, 65536, 4096, "float32", "float32")]


def _inputs(torch, b, s, d, xdt, adt, seed=5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(
        getattr(torch, xdt))
    a = (torch.rand((b, s, d), generator=gen, device="cuda") * 0.199
         + 0.8).to(getattr(torch, adt))
    h0 = torch.randn((b, d), generator=gen, device="cuda")
    return x, a, h0


def bound_ms(x, a, h0) -> float:
    """x and a read once, h (x's dtype) written once, h0 read once, over
    the card's memory rate: the bytes bound (2 flops a step never bind)."""
    n = x.numel() * (2 * x.element_size() + a.element_size()) \
        + h0.numel() * h0.element_size()
    return n / HBM_BYTES_PER_S * 1e3


def device_us(torch, fn, iters):
    """(device us per call of every device op, of the ``rg_lru`` kernels
    alone, their names) from the profiler, after one call outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(10):        # a profile now and then records no events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if events and all(e.count % iters == 0 for e in events):
            break
    total = sum(e.self_device_time_total for e in events) / iters
    kernel = sum(e.self_device_time_total for e in events
                 if "rg_lru" in e.key) / iters
    names = sorted({m.group(0) if (m := re.search(r"rg_lru_\w+", e.key))
                    else e.key[:60] for e in events})
    return total, kernel, names


def event_ms(torch, fn, iters, flush=None):
    """Mean ms per call from CUDA events around each call (``flush``
    zeroed before each, if given), after two calls."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def time_shapes(torch, rg_lru_cuda):
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = []
    for b, s, d, xdt, adt in SHAPES:
        x, a, h0 = _inputs(torch, b, s, d, xdt, adt)
        iters = 20 if s <= 2048 else 5
        dev, ker, names = device_us(torch, lambda: rg_lru_cuda(x, a, h0),
                                    iters)
        ms = event_ms(torch, lambda: rg_lru_cuda(x, a, h0), iters, flush)
        row = {"shape": f"B={b} S={s} D={d} x {xdt} a {adt}",
               "device_us": dev, "kernel_us": ker, "ms": ms,
               "bound_ms": bound_ms(x, a, h0), "kernels": names}
        rows.append(row)
        print(f"[B5] {row['shape']}: device us/call {dev:.2f} (kernel "
              f"{ker:.2f}) ms/call {ms:.4f} bound_ms {row['bound_ms']:.4f}"
              f" | {', '.join(names)}", flush=True)
        del x, a, h0
        torch.cuda.empty_cache()
    return rows


def sweep(torch):
    """Every ring tiling that fits, at the ``SWEEP`` shapes, beside the
    plan's."""
    from repro_torch.kernels import rg_lru
    lib = rg_lru._library()
    out = []
    for b, s, d, xdt, adt in SWEEP:
        x, a, h0 = _inputs(torch, b, s, d, xdt, adt)
        h = torch.empty_like(x)
        xs, asz = x.element_size(), a.element_size()
        picked = rg_lru.launch_plan(b, s, d, xs, asz, xs, x.data_ptr(),
                                    a.data_ptr(), h.data_ptr())
        bound = bound_ms(x, a, h0)
        results = []
        for dt in (32, 64, 128):
            blocks = b * -(-d // dt)
            for st in (8, 16, 32, 64, 128):
                for ns in (2, 3, 4, 6, 8, 12, 16):
                    smem = rg_lru.ring_smem(dt, st, ns, xs, asz)
                    if smem > rg_lru.SMEM_LIMIT:
                        continue
                    plan = rg_lru.LaunchPlan(True, dt, st, ns, blocks,
                                             dt + 32, smem)
                    ms = event_ms(torch, lambda: rg_lru._launch(
                        lib, x, a, h0, h, plan), 10)
                    results.append((ms, dt, st, ns, smem))
        results.sort()
        mine = event_ms(torch, lambda: rg_lru._launch(lib, x, a, h0, h,
                                                       picked), 10)
        shape = f"B={b} S={s} D={d} {xdt}/{adt}"
        print(f"[sweep] {shape}: bound {bound:.4f} ms; launch_plan "
              f"{picked.dt}/{picked.st}/{picked.ns} {mine:.4f} ms; best: "
              + "; ".join(f"{dt}/{st}/{ns} {ms:.4f}"
                          for ms, dt, st, ns, _ in results[:8]), flush=True)
        out.append({"shape": shape, "bound_ms": bound,
                    "plan": [picked.dt, picked.st, picked.ns, mine],
                    "all": results})
        del x, a, h0, h
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(here)),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    sys.path[0] = os.path.abspath(args.src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_rg_lru: no CUDA device")
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    import repro_torch
    print(f"[B5] timing {os.path.dirname(repro_torch.__file__)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    result = {"src": os.path.abspath(args.src),
              "device": torch.cuda.get_device_name(0)}
    if args.sweep:
        result["sweep"] = sweep(torch)
    else:
        result["shapes"] = time_shapes(torch, rg_lru_cuda)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh)


if __name__ == "__main__":
    main()
