"""Host time of the packed decode step, one checkout beside another.

    python src/repro_torch/launch/bench_host_step.py \
        [--src DIR ...] [--rounds 10] [--steps 64] [--backend lut_cuda]
    python src/repro_torch/launch/bench_host_step.py --hooks

Runs the decode that ``launch/profile_serve.py`` times (smollm-135m at
full width, W4A8 linears through ``--backend``, the paged-attention
kernel, 4 slots of 128-token prompts, random weights drawn on the card)
in a fresh process per run, importing ``repro_torch`` from the package
under each ``--src`` (default: this checkout's ``src``), so that a
parent checkout unpacked with ``git archive`` under the gitignored
``build/`` is timed by the same code. With two checkouts the runs go in
turns, A B B A A B ..., ``--rounds`` of each; one untimed run per
checkout first builds its kernels.

Each run times ``--steps`` steps after two warm-up steps, each step both
by the host clock around ``step()`` + ``torch.cuda.synchronize()`` and
by the main thread's CPU time (``time.thread_time``), which time the
thread spends preempted by other processes does not count. Per
checkout it reports the least step over all runs, the median step, and
the median CPU time a step, and then each figure's ratio to the first
checkout's. The last line is a JSON object of the same numbers.

``--hooks`` (this checkout only) prices the trace points instead: the
host time of one ``with scope(...)`` and one ``note_launch`` with no
recorder active (``timeit``, 200,000 calls each, on CUDA tensors), how
many of each one decode step makes (counted with a counting recorder
installed), and their product, the instrumentation's host time a step.
CUDA only.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.dirname(os.path.dirname(HERE))


def _child(args) -> None:
    """One run in this process: print one JSON line of per-step times."""
    import torch

    eng = _engine(args)
    walls, cpus = [], []
    for _ in range(args.steps):
        t0, c0 = time.perf_counter(), time.thread_time()
        eng.step()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        cpus.append(1e3 * (time.thread_time() - c0))
    print(json.dumps({"walls_ms": walls, "cpu_ms": cpus}))


def _engine(args):
    """The decode engine of a run, admitted and warmed up."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    cfg = serve_config(get_config(args.arch), backend=args.backend)
    cfg = cfg.replace(paged_kernel=True)
    model = Model(cfg, device="cuda")
    params = model.attach_device_plans(model.init(0, on_device=True))
    eng = ServeEngine(model, params, n_slots=4, max_len=256, page_size=16,
                      paged_kernel=True, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab, size=128).tolist(),
                   args.steps + 8)                 # never finishes here
    for _ in range(3):                             # admission + 2 warm-up
        eng.step()
    torch.cuda.synchronize()
    return eng


def _hooks(args) -> None:
    """Price the trace points: per call with no recorder, calls a step."""
    import timeit

    import torch

    from repro_torch import tracepoints
    from repro_torch.tracepoints import note_launch, recording, scope

    x = torch.ones(4, device="cuda")
    n = 200_000

    def with_scope():
        with scope("int_einsum"):
            pass
    scope_us = timeit.timeit(with_scope, number=n) / n * 1e6
    launch_us = timeit.timeit(
        lambda: note_launch("B3.tgemm_lut", (x, x), (x,)),
        number=n) / n * 1e6

    class Counter:
        launches = 0

        def launch(self, name, inputs, outputs):
            Counter.launches += 1

    scopes = [0]
    plain_scope = tracepoints._Scope

    class CountingScope(plain_scope):
        __slots__ = ()

        def __init__(self, name, loop):
            scopes[0] += 1
            super().__init__(name, loop)
    eng = _engine(args)
    tracepoints._Scope = CountingScope
    try:
        with recording(Counter()):
            eng.step()
            torch.cuda.synchronize()
    finally:
        tracepoints._Scope = plain_scope
    per_step = scopes[0] * scope_us + Counter.launches * launch_us
    out = {"card": _card(), "arch": args.arch, "backend": args.backend,
           "scope_us": scope_us, "note_launch_us": launch_us,
           "scopes_a_step": scopes[0], "launches_a_step": Counter.launches,
           "hooks_us_a_step": per_step}
    print(f"[host step] {out['card']}: no recorder, with scope(...) "
          f"{scope_us:.3f} us, note_launch {launch_us:.3f} us a call; one "
          f"decode step makes {scopes[0]} scopes and {Counter.launches} "
          f"launches: {per_step:.1f} us a step")
    print(json.dumps(out))


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]


def _run(src: str, args, steps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=src)
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--steps", str(steps), "--arch", args.arch,
           "--backend", args.backend]
    r = subprocess.run(cmd, env=env, cwd=os.path.dirname(src),
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"run from {src} failed ({r.returncode}):\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=None,
                    help="a checkout's src directory (repeatable)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--backend", default="lut_cuda")
    ap.add_argument("--hooks", action="store_true",
                    help="price the trace points (this checkout only)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.hooks:
        sys.path.insert(0, SRC)
        _hooks(args)
        return
    if args.child:
        _child(args)
        return
    if not 1 <= args.steps <= 100:
        raise SystemExit("--steps must be 1..100 (128-token prompts in a "
                         "256-token window)")
    srcs = [os.path.abspath(s) for s in (args.src or [SRC])]
    card = _card()
    print(f"[host step] {card}")
    for src in srcs:                               # builds the kernels
        t0 = time.perf_counter()
        _run(src, args, 1)
        print(f"[host step] warm-up run from {src}: "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = {src: [] for src in srcs}
    for r in range(args.rounds):
        for src in (srcs if r % 2 == 0 else srcs[::-1]):
            res = _run(src, args, args.steps)
            runs[src].append(res)
            print(f"[host step] round {r} {src}: min "
                  f"{min(res['walls_ms']):.2f} ms, median "
                  f"{statistics.median(res['walls_ms']):.2f} ms, cpu "
                  f"median {statistics.median(res['cpu_ms']):.2f} ms",
                  flush=True)
    out = {"card": card, "arch": args.arch, "backend": args.backend,
           "steps": args.steps, "rounds": args.rounds, "checkouts": {}}
    first = None
    for src in srcs:
        walls = [w for res in runs[src] for w in res["walls_ms"]]
        cpus = [c for res in runs[src] for c in res["cpu_ms"]]
        row = {"min_ms": min(walls), "median_ms": statistics.median(walls),
               "cpu_median_ms": statistics.median(cpus),
               "run_mins_ms": [min(res["walls_ms"]) for res in runs[src]]}
        first = first or row
        row["ratios"] = {k: row[k] / first[k] for k in
                         ("min_ms", "median_ms", "cpu_median_ms")}
        out["checkouts"][src] = row
        print(f"[host step] {src}: least step {row['min_ms']:.3f} ms, "
              f"median {row['median_ms']:.3f} ms, cpu median "
              f"{row['cpu_median_ms']:.3f} ms | against the first: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["ratios"].items()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
