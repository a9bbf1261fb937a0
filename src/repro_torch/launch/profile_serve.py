"""Where the time of the port's serving paths goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch smollm_135m] [--backend engine_cuda|lut_cuda | --fp] \
        [--steps 8] [--oneshot]

Builds the serving path (``--arch``, smollm-135m by default, at full
width unless ``--reduced``,
W4A8 linears through ``--backend``: the forest kernel with ``engine_cuda``,
the default, which first plans every linear, or the doubling-LUT kernel
with ``lut_cuda``; or, with ``--fp``, the base config unquantized: bf16
linears, float attention over an exact pool; the paged-attention kernel,
bf16, random weights from ``--seed`` drawn on the card), admits
``--slots`` requests of
``--prompt-len`` tokens, then:

  * times ``--steps`` packed decode steps with the host clock around
    ``step()`` + ``torch.cuda.synchronize()`` (ms per step);
  * runs the same number of further steps under ``torch.profiler`` (the
    profile opened by ``device_events``' primer launches, left out) and
    reports device time per step by kernel (the port's CUDA kernels by
    their entry names, everything else grouped), and the device
    busy share = summed kernel time / wall time of the window (one
    stream, so kernels do not overlap). For an MoE config it also gives
    the device time and launches of the kernels run inside the MoE
    block's profiler ranges (``models.blocks.apply_moe``: the router;
    the experts' products and their combine) apart from the rest.

With ``--oneshot`` the step is ``greedy_generate``'s instead (the path
of configs the paged engine does not cover, recurrentgemma-9b among
them): a batch of ``--slots`` prompts is prefilled into dense caches
(that prefill is profiled too: one call, its device time by kernel), and
each step is one ``Model.decode_step`` and its argmax.

If the profiler records no device events, the device columns read "not
measured". CUDA only: a host without a card raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.backend import list_backends
from repro_torch.launch.device_events import PRIMER, PRIMER_LAUNCHES
from repro_torch.launch.specs import serve_config
from repro_torch.models.model import Model
from repro_torch.serve import ServeEngine

# kernel entry names of the port (as the profiler shows them) -> label
PORT_KERNELS = {"forest_narrow": "B1 forest, narrow blocks (M <= 8)",
                "forest_wide": "B1 forest, wide blocks (M > 8)",
                "paged_decode": "B2 paged attention",
                "forest_fused16": "B1 forest, int16 plan (9 <= T <= 15)",
                "forest_dense": "B1 forest from a dense plan (T >= 16)",
                "forest_sparse": "B1 forest, sparse plan (T >= 16)",
                "tgemm_lut": "B3 doubling-LUT transitive GEMM",
                "w4a8_dot": "B4 group-dequant GEMM",
                "w4a8_wgmma": "B4 group-dequant GEMM, tensor cores",
                "rg_lru_ring": "B5 linear recurrence, TMA ring",
                "rg_lru_regs": "B5 linear recurrence, unaligned rows"}


# profiler ranges of the port's blocks (record_function names) -> label
PORT_RANGES = {"moe.router": "MoE router (norm, f32 product, softmax, top-k)",
               "moe.experts": "MoE experts (sorted dispatch, three "
                              "grouped products, combine)"}


def _label(name: str) -> str:
    for key, label in PORT_KERNELS.items():
        if key in name:
            return label
    return name


def _device_events(prof):
    """(name, total device us, count) of every device-side event but the
    primer's."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA and PRIMER not in e.key
                and e.key not in PORT_RANGES):
            out.append((e.key, e.self_device_time_total, e.count))
    return out


def _range_events(prof):
    """(label, device us of the kernels launched inside, device launches
    inside, calls) of every profiler range of ``PORT_RANGES`` the profile
    holds (the host-side range: its kernels and its children's)."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in PORT_RANGES:
            out.append(e)
    rows = {}
    for e in out:
        r = rows.setdefault(e.name, [0.0, 0, 0])
        r[0] += e.device_time_total
        r[1] += _launches(e)
        r[2] += 1
    return [(PORT_RANGES[k], *v) for k, v in rows.items()]


def _launches(e) -> int:
    """Device kernels of a host event and its children."""
    return len(e.kernels) + sum(_launches(c) for c in e.cpu_children)


def _profiled(fn, n: int):
    """(profile, wall seconds) of ``n`` calls of ``fn``. The profile opens
    with ``device_events``' primer (a profile can lose its first launches
    after the card idled), outside the timed window."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return prof, window


def _report(prof, window: float, n: int, what: str, top: int) -> None:
    """Device busy share and time by kernel over ``n`` calls of ``what``
    profiled in ``window`` seconds."""
    events = _device_events(prof)
    busy_us = sum(t for _, t, _ in events)
    per = window * 1e3 / n
    if busy_us <= 0:
        print(f"[profile] {what}: window {per:.2f} ms each under the "
              f"profiler; device time: not measured (no device events "
              f"recorded)")
        return
    print(f"[profile] {what}: window {per:.2f} ms each under the profiler"
          f" | device busy {busy_us / 1e3 / n:.3f} ms each = "
          f"{busy_us / 1e6 / window:.3f} of wall (idle "
          f"{1 - busy_us / 1e6 / window:.3f})")
    grouped: dict[str, list] = {}
    for name, t, c in events:
        g = grouped.setdefault(_label(name), [0.0, 0])
        g[0] += t
        g[1] += c
    rows = sorted(grouped.items(), key=lambda kv: -kv[1][0])
    port_labels = set(PORT_KERNELS.values())
    other = [(t, c) for label, (t, c) in rows if label not in port_labels]
    print(f"[profile] {what}: {sum(c for _, _, c in events) // n} device "
          f"launches each; outside the port's kernels: "
          f"{sum(t for t, _ in other) / 1e3 / n:.4f} ms over "
          f"{sum(c for _, c in other) // n} launches")
    shown = rows[:top] + [r for r in rows[top:] if r[0] in port_labels]
    for label, (t, c) in shown:        # the port's kernels always shown
        print(f"  {t / 1e3 / n:9.4f} ms {t / busy_us:6.3f} of device | "
              f"{c // n:5d} launches | {label[:90]}")
    ranges = _range_events(prof)
    if ranges:
        inside = sum(t for _, t, _, _ in ranges)
        print(f"[profile] {what}: by the port's profiler ranges (device "
              f"time of the kernels launched inside)")
        for label, t, c, calls in ranges:
            print(f"  {t / 1e3 / n:9.4f} ms {t / busy_us:6.3f} of device | "
                  f"{c // n:5d} launches | {calls // n} calls | {label}")
        print(f"  {(busy_us - inside) / 1e3 / n:9.4f} ms "
              f"{1 - inside / busy_us:6.3f} of device | the rest")


def _oneshot(model, params, args):
    """(admit, step) over dense caches: admit prefills ``--slots`` prompts;
    each step is one decode step and its argmax, on the device."""
    cfg = model.cfg
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(args.slots, args.prompt_len)))
    max_len = args.prompt_len + 2 * args.steps + 10
    state = {}

    def admit():
        logits, state["caches"] = model.prefill(params, {"tokens": tokens},
                                                max_len)
        state["tok"] = torch.argmax(logits[:, -1], -1)[:, None]
        state["step"] = args.prompt_len

    def step():
        logits, _ = model.decode_step(params, state["caches"], state["tok"],
                                      state["step"])
        state["tok"] = torch.argmax(logits[:, -1], -1)[:, None]
        state["step"] += 1
    return admit, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--backend", default="engine_cuda",
                    choices=list_backends(),
                    help="integer-GEMM backend of the PTQ linears")
    ap.add_argument("--fp", action="store_true",
                    help="the base config unquantized (no backend)")
    ap.add_argument("--oneshot", action="store_true",
                    help="profile greedy_generate's decode step over dense "
                    "caches (batch --slots) instead of ServeEngine's")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    base = get_reduced(args.arch) if args.reduced else \
        get_config(args.arch)
    cfg = base if args.fp else serve_config(base, backend=args.backend)
    cfg = cfg.replace(paged_kernel=True)
    model = Model(cfg, device="cuda")
    params = model.attach_device_plans(model.init(args.seed,
                                                  on_device=True))
    if args.oneshot:
        admit, step = _oneshot(model, params, args)
    else:
        eng = ServeEngine(model, params, n_slots=args.slots, max_len=256,
                          page_size=16, paged_kernel=True, device="cuda")
        rng = np.random.default_rng(args.seed + 1)
        gen = 1 + 3 * args.steps                # never finishes in-window
        for _ in range(args.slots):
            eng.submit(rng.integers(0, cfg.vocab,
                                    size=args.prompt_len).tolist(), gen)
        admit = step = eng.step                 # admission + 1st decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    admit()
    torch.cuda.synchronize()
    t_admit = time.perf_counter() - t0
    step()                                      # warm-up decode
    torch.cuda.synchronize()

    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    step_ms = 1e3 * sum(walls) / len(walls)
    mode = "one-shot (greedy_generate)" if args.oneshot else "ServeEngine"
    print(f"[profile] {cfg.name} ({cfg.n_layers} layers, "
          f"{'fp' if args.fp else 'backend ' + args.backend}, {mode}, "
          f"{torch.cuda.get_device_name(0)}) | {args.slots} slots x "
          f"{args.prompt_len}-token prompts | "
          f"{'prefill' if args.oneshot else 'admission + first decode'} "
          f"{t_admit * 1e3:.1f} ms | decode step {step_ms:.2f} ms "
          f"(host clock, mean of {args.steps}, min "
          f"{1e3 * min(walls):.2f}) -> {args.slots / step_ms * 1e3:.1f} "
          f"tokens/s")

    if args.oneshot:
        _report(*_profiled(admit, 1), 1, "prefill", args.top)
    _report(*_profiled(step, args.steps), args.steps, "decode step",
            args.top)


if __name__ == "__main__":
    main()
