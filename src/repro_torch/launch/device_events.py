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
second spin and as many tiny launches before its last synchronize: the
calls sit at least a spin and the primer away from both edges, and the
primer and the spins are left out of the result. A read counts only if
it holds events and every kernel's count is a multiple of ``calls``,
else it is taken again with both spins twice as long (up to ``PAD_MAX``)
and four times the primer (up to ``PRIMER_MAX``);
``device_events.retries`` counts such reads and
``device_events.primers_lost`` the most primer and spin records one read
lost. Each call starts again from ``PAD_CYCLES`` and
``PRIMER_LAUNCHES``: a longer window lasts one read. Reads lose launches
only late in a run, and more the later. Eleven minutes into
``chip_smoke.py`` runs on an H100, reads with ~20 ms spins kept 10 of 20
calls of a ~25 µs kernel, and reads with spins doubled to ~320 ms kept
17 of 20 calls of a ~3 ms one; ten reads with spins up to ~1.3 s kept 10
of 20 calls of a ~40 µs one; the same reads two minutes into a run kept
every launch.
``chip_smoke.py``, the card tests,
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
           "PRIMER", "PRIMER_LAUNCHES", "PRIMER_MAX", "PAD_CYCLES",
           "PAD_MAX"]

PRIMER = "spin_kernel"          # the kernel of torch.cuda._sleep
PRIMER_LAUNCHES = 32            # more than a profile was seen to lose
PRIMER_MAX = 256 * PRIMER_LAUNCHES
PAD_CYCLES = 40_000_000         # ~20 ms at the H100's 1.98 GHz SM clock
PAD_MAX = 64 * PAD_CYCLES       # ~1.3 s


def open_window(cycles: int = PAD_CYCLES,
                primers: int = PRIMER_LAUNCHES) -> None:
    """Inside a profile, before the calls it reads: ``primers`` tiny
    launches and a spin of ``cycles``, then a synchronize."""
    import torch
    for _ in range(primers):
        torch.cuda._sleep(100)
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()


def close_window(cycles: int = PAD_CYCLES,
                 primers: int = PRIMER_LAUNCHES) -> None:
    """Inside a profile, after the calls it reads: a spin of ``cycles``
    and ``primers`` tiny launches, then a synchronize."""
    import torch
    torch.cuda._sleep(cycles)
    for _ in range(primers):
        torch.cuda._sleep(100)
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
    pad, primers = PAD_CYCLES, PRIMER_LAUNCHES
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window(pad, primers)
            for _ in range(calls):
                fn()
            close_window(pad, primers)
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        events = [e for e in device if PRIMER not in e.key]
        kept = sum(e.count for e in device if PRIMER in e.key)
        device_events.primers_lost = max(device_events.primers_lost,
                                         2 * primers + 2 - kept)
        if events and all(e.count % calls == 0 for e in events):
            break
        device_events.retries += 1
        pad = min(2 * pad, PAD_MAX)
        primers = min(4 * primers, PRIMER_MAX)
        time.sleep(0.05)
    return events


device_events.retries = 0
device_events.primers_lost = 0


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
