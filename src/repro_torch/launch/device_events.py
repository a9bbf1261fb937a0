"""The device kernels a call runs, read from ``torch.profiler`` so that a
lost record does not pass for a missing launch.

A profile can lose launches at either end of its window on the H100
machines this port is measured on. At the start: after ~25 s of
host-bound planning, or after the card had idled ~20 s, reads of 4 calls
kept 2, then 1 (of one call: none), read after read, while the same reads
on a busy card kept every launch (``PERF.md`` §6). At the end: ten reads
in a row of 20 calls of a 9.5 ms kernel kept 19, nine minutes into a
``chip_smoke.py`` run. The profiler keeps a device record only if it lies
inside the host's window once moved to the host clock, so a record near
either edge can fall out when the two clocks disagree. So each profile
here opens with ``PRIMER_LAUNCHES`` tiny launches and one spin of
``PAD_CYCLES`` device cycles (``torch.cuda._sleep``), and closes with a
second spin before its last synchronize: the calls sit at least a spin
away from both edges, and the spins are left out of the result. A read
counts only if it holds events and every kernel's count is a multiple of
``calls``, else it is taken again. ``chip_smoke.py``, the card tests,
``launch/profile_serve.py`` and ``launch/bench_forest_sparse.py`` read
through it. CUDA only.

    python -m repro_torch.launch.device_events [--idle SECONDS]

prints how many launches plain profiles of 1 and of 4 calls keep, and how
many ``device_events`` reads keep, on a busy card and after it idled, for
a short kernel and a ~10 ms one.
"""
from __future__ import annotations

import argparse
import sys
import time

__all__ = ["device_events", "kernel_names", "open_window", "close_window",
           "PRIMER", "PRIMER_LAUNCHES", "PAD_CYCLES"]

PRIMER = "spin_kernel"          # the kernel of torch.cuda._sleep
PRIMER_LAUNCHES = 32            # more than a profile was seen to lose
PAD_CYCLES = 40_000_000         # ~20 ms at the H100's 1.98 GHz SM clock


def open_window() -> None:
    """Inside a profile, before the calls it reads: the primer launches
    and a spin, then a synchronize."""
    import torch
    for _ in range(PRIMER_LAUNCHES):
        torch.cuda._sleep(100)
    torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


def close_window() -> None:
    """Inside a profile, after the calls it reads: a spin, then a
    synchronize."""
    import torch
    torch.cuda._sleep(PAD_CYCLES)
    torch.cuda.synchronize()


def device_events(fn, calls: int = 1, attempts: int = 10):
    """The profiler's device events (``key_averages``, the primer and
    the spins left out) of ``calls`` calls of ``fn``, after one call outside the profile:
    the first read that holds every launch, else the last read (which then
    shows what was lost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(calls):
                fn()
            close_window()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and PRIMER not in e.key]
        if events and all(e.count % calls == 0 for e in events):
            break
        time.sleep(0.05)
    return events


def kernel_names(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` launches, one
    entry per launch (the profiler's names, template arguments
    included)."""
    return [e.key for e in device_events(fn) for _ in range(e.count)]


def _plain_read(fn, calls: int) -> int:
    """The launches one plain profile of ``calls`` calls of ``fn`` keeps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--idle", type=float, default=20.0)
    ap.add_argument("--reads", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("device_events: needs a CUDA device", file=sys.stderr)
        return 2
    x = torch.zeros(1024, device="cuda")
    a = torch.randn(6144, 6144, device="cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = (("x.add_", lambda: x.add_(1), 4),     # one short launch a call
             ("6144^3 f32 mm", lambda: a @ a, 20))  # ~10 ms a call
    for state in ("busy card", f"after {args.idle:g} s idle"):
        if state != "busy card":
            torch.cuda.synchronize()
            time.sleep(args.idle)
        for what, fn, calls in cases:
            each = sum(e.count for e in device_events(fn, 1))
            plain1 = [_plain_read(fn, 1) for _ in range(args.reads)]
            plain = [_plain_read(fn, calls) for _ in range(args.reads)]
            kept = [sum(e.count for e in device_events(fn, calls))
                    for _ in range(args.reads)]
            print(f"{torch.cuda.get_device_name(0)}, {state}, {what} "
                  f"({each} launch(es) a call): plain profiles of 1 call "
                  f"kept {plain1}; of {calls} calls {plain}; device_events "
                  f"of {calls} calls {kept}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
