"""Serving launcher of the port: one-shot batched greedy generation over
dense caches, or continuous batching through the paged-KV serve engine
(``--continuous``); W4A8 TransitiveLinear + dynamic int8 attention + KV8
cache, or (``--fp``) the base config unquantized.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --continuous --backend lut_cuda --paged-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --continuous --fp --paged-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama1-7b \
      --continuous --backend lut_cuda --paged-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --backend lut_cuda --batch 4 \
      --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch moonshot-v1-16b-a3b --continuous --backend lut_cuda \
      --paged-kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
      --backend lut_cuda --batch 4 --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --backend lut_cuda --batch 4 --prompt-len 128 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given; random weights from
``--seed`` are drawn on that device (``Model.init(on_device=True)``: a
full-width 7B model is made on the card in seconds).

Without ``--continuous`` (the one-shot mode) ``--batch`` prompts of
``--prompt-len`` tokens, drawn from ``--seed``, go through
``greedy_generate``: one prefill into dense, layer-stacked caches of
``max_len = prompt_len + gen + 8`` positions (rolling ones of the local
window where the config has one), then ``--gen`` tokens. The report
prints tokens, seconds, tokens/s and the kernel launch counts. This is
how the reference serves configs the paged path does not cover
(``Model.supports_paged``), recurrentgemma-9b, xlstm-125m, whisper-tiny
and llama-3.2-vision-90b among them: with ``--continuous`` they are
refused with its reason. A config with cross blocks gets seeded context
embeddings (:func:`oneshot_batch`): whisper-tiny's 1,500 frames go
through its encoder, llama-3.2-vision-90b's 1,024 patches straight to
its cross blocks.

With ``--continuous`` requests arrive
staggered (``--requests`` of them, one every ``--arrive-every`` host
steps) into ``--slots`` packed decode slots over a paged KV pool of
``--page-size``-token pages; even requests repeat a base prompt and odd
ones share its first half, so the prefix trie shares pages. Planned
backends (``engine_torch``, ``engine_cuda``) build every linear's plan
once before serving and serve from plans attached to the params; the
LUT backends (``lut``, ``lut_cuda``) and ``int_dot`` need no plan and
build none. ``--fp`` serves the base config as the reference's launcher
does: dense bf16 linears (``torch.matmul``, no backend), float attention
and an exact bf16 KV pool; ``--paged-kernel`` then decodes through the
paged-attention kernel's exact-pool float layout. The report prints
per-request TTFT and latency, tokens/s, the prefix-reuse counters and the
kernel launch counts.

The fleet flags (``repro_torch.fleet``):

  * ``--role planner --bundle-dir D`` plans every linear once, writes
    fingerprinted plan bundles to ``D`` and exits; ``--role server
    --bundle-dir D`` attaches those bundles instead of planning and exits
    non-zero if any plan was built on it, or if the bundles do not match
    its weights, config or backend.
  * ``--watch-weights D`` (with ``--continuous``) serves through a live
    weight update: half the requests are admitted on generation 0, the
    launcher writes new weights (``--swap-seed``) as a checkpoint in ``D``
    after ``--swap-after`` host steps, a ``WeightWatcher`` hands them to a
    ``ReplanWorker`` that plans them on its own thread while the engine
    keeps stepping, and the engine swaps at a step boundary: in-flight
    requests finish on the weights that admitted them, the rest run on
    generation 1. ``--assert-swap-identity`` then exits non-zero unless
    every finished request equals its generation's requests served alone
    on a fresh engine with the same admission schedule.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --backend engine_cuda --role planner --bundle-dir B \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --backend engine_cuda --role server --bundle-dir B \
      --continuous --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --backend engine_cuda --continuous --watch-weights W \
      --assert-swap-identity --device cpu

The reference's other launch flags:

  * ``--path`` is the deprecated spelling of ``--backend``: it warns
    (``DeprecationWarning``), and ``--backend`` wins when both are given.
  * ``--no-bucket-prefill`` (with ``--continuous``) prefills each request
    alone at batch 1 instead of in bucketed batches; the report says
    ``prefill=per-request``.
  * ``--no-precompile`` skips planning every linear before serving; a
    planned backend then builds each plan through the plan cache while
    its plans are attached to the params.

``--lint`` runs the reference's preflight before anything is built, on
``--device``: tracelint over the backend's serving programs at the
arch's reduced widths (``analysis.programs.lint_backend``: prefill,
decode, paged decode and its swapped twin, the B2 kernel's decode on
``cuda``, bucketed prefill, the forest), then the plan verifier
(``analysis.planlint.lint_plans``: representative plans, lowerings and a
bundle round trip). It prints each finding and the seconds, and refuses
to serve (exit 2) on an error finding.

``--mesh data=N`` (or ``pod=P,data=D``) serves the data-parallel cell:
the launcher builds the CUDA kernels once, starts N ranks
(``launch.mesh.run_cli_on_mesh``; inside a process group that is already
initialised it uses that one), and every rank draws the same weights,
places its plans on the mesh (replicated) and serves its rows of the
batch (``greedy_generate(mesh=)``) or of the packed slots
(``ServeEngine(mesh=)``); ``--lint`` runs under the mesh, and ``--role
server`` loads the bundles onto it. Rank 0 prints, ending with
``mesh_decode_report``'s line (``--continuous``: ``mesh_serve_report``'s,
the same line over the slots, with the requests and tokens served). A ``model`` axis above 1 exits 2 (ROADMAP
A10.2), and so do ``--watch-weights`` (each rank's watcher would see the
checkpoint at its own step) and ``--role planner`` (planning is one
process's work) under a mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --continuous --backend engine_cuda --lint --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.backend import get_backend, list_backends
from repro_torch.launch.specs import (mesh_decode_report, mesh_serve_report,
                                      serve_config)
from repro_torch.models.model import Model
from repro_torch.train.serve_step import greedy_generate


def prefix_sharing_prompts(vocab: int, n: int, length: int,
                           seed: int) -> list[list[int]]:
    """``n`` prompts of ``length`` tokens: even ones repeat a base prompt,
    odd ones share its first half (the launcher's arrival workload)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=length).tolist()
    half = length // 2
    return [list(base) if i % 2 == 0 else
            base[:half] + rng.integers(0, vocab, size=length - half).tolist()
            for i in range(n)]


def _mode(cfg) -> str:
    if cfg.quant.mode == "ptq":
        return (f"W{cfg.quant.w_bits}A8+KV{cfg.kv_cache_bits}/"
                f"{cfg.quant.backend}")
    return f"fp {str(cfg.dtype).removeprefix('torch.')}"


def oneshot_batch(model, batch: int, prompt_len: int, seed: int) -> dict:
    """The one-shot mode's batch: ``batch`` prompts of ``prompt_len``
    tokens drawn by numpy from ``seed + 1``, and, for a config with cross
    blocks, the frontend stub's context, ``(batch, n_context_tokens,
    d_model)`` standard normals x 0.02 in f32, drawn on the model's device
    from ``seed + 1`` (frame embeddings for an encoder-decoder, patch
    embeddings otherwise), as the reference's launcher makes them."""
    import torch
    cfg = model.cfg
    rng = np.random.default_rng(seed + 1)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(batch, prompt_len)))}
    if cfg.n_context_tokens or cfg.is_encdec:
        gen = torch.Generator(device=model.device).manual_seed(seed + 1)
        out["context"] = torch.randn(
            (batch, cfg.n_context_tokens, cfg.d_model), generator=gen,
            device=model.device) * 0.02
    return out


def generate_oneshot(model, params, args, mesh=None):
    """``--batch`` seeded prompts through ``greedy_generate`` over dense
    caches (on ``mesh``'s ranks, each its rows, where given); returns the
    (batch, gen) tokens on the host."""
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda

    cfg = model.cfg
    batch = oneshot_batch(model, args.batch, args.prompt_len, args.seed)
    max_len = args.prompt_len + args.gen + 8
    kernels = (transitive_forest, transitive_gemm_cuda, rg_lru_cuda)
    launches0 = [k.launches for k in kernels]
    t0 = time.perf_counter()
    toks = greedy_generate(model, params, batch, max_len=max_len,
                           n_steps=args.gen, mesh=mesh).cpu()
    dt = time.perf_counter() - t0
    n = args.batch * args.gen
    print(f"[{cfg.name} | {_mode(cfg)} | one-shot | {model.device}] "
          f"generated {args.batch}x{args.gen} tokens from "
          f"{args.prompt_len}-token prompts (max_len {max_len}) in "
          f"{dt:.2f}s -> {n / dt:.1f} tok/s")
    print(f"[kernels] transitive_forest launches="
          f"{transitive_forest.launches - launches0[0]} transitive_gemm "
          f"launches={transitive_gemm_cuda.launches - launches0[1]} rg_lru "
          f"launches={rg_lru_cuda.launches - launches0[2]}")
    for i, row in enumerate(toks.tolist()):
        print(f"  row {i}: {row}")
    if mesh is not None:
        print(mesh_decode_report(mesh, args.batch, args.gen, dt))
    return toks


def serve_continuous(model, params, args, raw_params=None, mesh=None):
    """Staggered arrivals through ServeEngine; returns the engine.

    With ``--watch-weights`` a live weight update lands mid-run: the first
    half of the requests is admitted on generation 0, the new weights are
    written as a checkpoint after ``--swap-after`` host steps, the
    ``WeightWatcher`` / ``ReplanWorker`` pair plans them off-thread while
    the engine keeps stepping, and the rest of the requests wait for
    generation 1. While the engine has nothing to decode it waits on the
    replan instead of spinning, so the planner is not starved of the
    interpreter."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.serve import ServeEngine

    cfg = model.cfg
    ps = args.page_size
    max_len = -(-(args.prompt_len + args.gen) // ps) * ps
    eng = ServeEngine(model, params, n_slots=args.slots, max_len=max_len,
                      page_size=ps, mesh=mesh,
                      paged_kernel=args.paged_kernel,
                      bucket_prefill=not args.no_bucket_prefill,
                      device=model.device)
    prompts = prefix_sharing_prompts(cfg.vocab, args.requests,
                                     args.prompt_len, args.seed + 1)
    kernels = (transitive_forest, transitive_gemm_cuda, paged_attention)
    launches0 = [k.launches for k in kernels]

    hot = args.watch_weights
    worker = watcher = ticket = None
    gen_raw = {0: raw_params}
    failures = []
    if hot:
        from repro_torch.distributed import checkpoint
        from repro_torch.fleet import ReplanWorker, WeightWatcher

        def _on_ready(g):
            new_gen = eng.swap_params(g.params, tag=g.tag)
            print(f"[hotswap] generation {new_gen} staged (checkpoint step "
                  f"{g.tag}, build {g.build_s:.2f}s, {g.plans_built} plan "
                  f"builds, off-thread)")

        def _on_error(e):
            failures.append(e)
            print(f"[hotswap] replan FAILED — previous generation keeps "
                  f"serving (rollback): {e}")

        worker = ReplanWorker(model, reference=params, on_ready=_on_ready,
                              on_error=_on_error)
        watcher = WeightWatcher(hot, raw_params, worker)
        # react only to checkpoints newer than what the directory holds
        watcher.seen_step = checkpoint.latest_step(hot)
        new_raw = model.init(args.swap_seed, on_device=True)
        gen_raw[1] = new_raw
        ckpt_written = False

    # with a staged swap, the second half of the requests waits for gen 1
    first = (args.requests + 1) // 2 if hot else args.requests
    submitted = host_step = 0
    admitted = {}                      # request id -> host step admitted
    t0 = time.perf_counter()
    try:
        while (submitted < args.requests or eng.queue or eng.active
               or (hot and eng.generation == 0 and not failures)):
            limit = (first if (hot and eng.generation == 0)
                     else args.requests)
            if (submitted < limit
                    and host_step >= submitted * args.arrive_every):
                eng.submit(prompts[submitted], args.gen)
                submitted += 1
            if hot:
                if not ckpt_written and host_step >= args.swap_after:
                    step = (watcher.seen_step or 0) + 1
                    checkpoint.save(hot, step, new_raw)
                    ckpt_written = True
                    print(f"[hotswap] new weights written as checkpoint "
                          f"step {step} at host step {host_step}")
                ticket = watcher.poll() or ticket
            eng.step()
            for r in [*eng.active.values(), *eng.finished]:
                admitted.setdefault(r.rid, host_step)
            host_step += 1
            if (ticket is not None and not ticket.done and not eng.active
                    and not eng.queue):
                ticket.wait(0.05)
    finally:
        if worker is not None:
            worker.stop()
    dt = time.perf_counter() - t0
    rep = eng.report()
    print(f"[{cfg.name} | {_mode(cfg)} | "
          f"continuous | {model.device}] {rep['n_requests']} requests x "
          f"{args.gen} tokens ({args.slots} slots, page_size={ps}) in "
          f"{dt:.2f}s -> {rep['tokens_per_s']:.1f} tok/s")
    for r in rep["requests"]:
        print(f"  req {r['rid']}: prompt={r['prompt_len']} "
              f"tokens={r['n_tokens']} shared_pages={r['shared_pages']} "
              f"prefill_computed={r['prefill_computed']} "
              f"ttft={r['ttft_s'] * 1e3:.1f}ms "
              f"latency={r['latency_s'] * 1e3:.1f}ms")
    c = rep["counters"]
    print(f"[prefix reuse] hits={c['prefix_hits']} "
          f"pages_shared={c['pages_shared']} "
          f"prefill_skipped={c['prefill_skipped']} "
          f"prefill_computed={c['prefill_computed']} | "
          f"pages={c['pages']} trie={c['trie']}")
    print(f"[kernels] transitive_forest launches="
          f"{transitive_forest.launches - launches0[0]} transitive_gemm "
          f"launches={transitive_gemm_cuda.launches - launches0[1]} "
          f"paged_attention launches="
          f"{paged_attention.launches - launches0[2]} | decode="
          f"{'paged-kernel' if args.paged_kernel else 'gather'} prefill="
          f"{'per-request' if args.no_bucket_prefill else 'bucketed'}")
    for r in eng.finished:
        gen = f" gen={r.gen}" if hot else ""
        print(f"  req {r.rid}:{gen} {r.tokens}")
    if hot:
        _hotswap_report(model, eng, args, failures, gen_raw, worker,
                        admitted)
    if mesh is not None:
        print(f"[mesh] packed decode placements: "
              f"{_placements(eng.decode_placements)}")
        print(mesh_serve_report(mesh, args.slots, rep["n_requests"],
                                rep["total_tokens"],
                                rep["counters"]["decode_steps"], dt))
    return eng


def _placements(placed: dict) -> str:
    return " ".join(f"{k}={list(map(str, v))}" for k, v in placed.items())


def replay(model, params, requests, admitted: dict, **engine_kw) -> dict:
    """Serve ``requests`` (one generation's, from a run) again on a fresh
    ``ServeEngine`` over ``params``, each submitted at the host step it was
    admitted at in that run, counted from the first: ``{request id:
    tokens}``. A cell of a multi-generation run sees the same admissions
    and packed decodes as this single-generation engine, so its requests'
    tokens must equal these."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, device=model.device, **engine_kw)
    order = sorted(requests, key=lambda r: (admitted[r.rid], r.rid))
    start = admitted[order[0].rid]
    rid_of = {}
    host_step = i = 0
    while i < len(order) or eng.queue or eng.active:
        while i < len(order) and admitted[order[i].rid] - start <= host_step:
            r = order[i]
            rid_of[eng.submit(r.prompt, r.max_new_tokens, r.eos_id)] = r.rid
            i += 1
        eng.step()
        host_step += 1
    return {rid_of[r.rid]: r.tokens for r in eng.finished}


def _hotswap_report(model, eng, args, failures, gen_raw, worker,
                    admitted):
    """Print the swap's outcome; with --assert-swap-identity, hold every
    finished request to its own generation served alone
    (SystemExit on any difference or a failed build).

    The reference compares each request with ``greedy_generate``, which
    the serve engine does not always equal (a prefix recomputed at
    another batch shape can round otherwise); the port replays each
    generation's requests on a fresh engine over that generation's
    weights with the run's admission schedule (:func:`replay`), which
    the engine must equal bit for bit."""
    s = eng.stats()
    print(f"[hotswap] generation={s['generation']} "
          f"swaps={s['swaps']} retired={s['generations_retired']} "
          f"swap_shape_drift={s['swap_shape_drift']} | worker: "
          f"{worker.stats()}")
    if failures:
        if args.assert_swap_identity:
            raise SystemExit(f"[hotswap] replan failed: {failures[0]}")
        return
    if not args.assert_swap_identity:
        return
    # plans attached anew from the raw weights (cache hits: the worker
    # built them)
    ps = args.page_size
    kw = dict(n_slots=args.slots, page_size=ps,
              max_len=-(-(args.prompt_len + args.gen) // ps) * ps,
              paged_kernel=args.paged_kernel,
              bucket_prefill=not args.no_bucket_prefill)
    gens = sorted({r.gen for r in eng.finished})
    bad = 0
    for g in gens:
        reqs = [r for r in eng.finished if r.gen == g]
        want = replay(model, model.attach_device_plans(gen_raw[g]), reqs,
                      admitted, **kw)
        for r in reqs:
            if r.tokens != want[r.rid]:
                bad += 1
                print(f"[hotswap] MISMATCH req {r.rid} (gen {g}): "
                      f"{r.tokens} != {want[r.rid]}")
    if bad or s["generation"] < 1:
        raise SystemExit(
            f"[hotswap] identity check FAILED: {bad} mismatching "
            f"request(s), final generation {s['generation']}")
    print(f"[hotswap] identity OK: {len(eng.finished)} request(s) across "
          f"generations {gens} each equal their generation served alone "
          f"on a fresh engine")


def lint_preflight(ap, name: str, args, mesh=None) -> None:
    """``--lint``: tracelint over ``name``'s serving programs at the arch's
    reduced widths (``analysis.programs.lint_backend``), then the plan
    verifier over its plan artifacts (``analysis.planlint.lint_plans``),
    both on ``args.device``; exits 2 through ``ap.error`` on any error
    finding of either. A plan the verifier refuses while the programs are
    built counts as that refusal's findings."""
    from repro_torch.analysis import planlint, programs
    t0 = time.perf_counter()
    try:
        progs, tfindings = programs.lint_backend(
            name, device=args.device, arch=args.arch, batch=args.batch,
            w_bits=args.w_bits, mesh=mesh)
        built = [p.name for p in progs if not p.skipped]
        skipped = [p.name for p in progs if p.skipped]
        what = (f"programs {', '.join(built)}"
                + (f"; skipped {', '.join(skipped)}" if skipped else ""))
    except planlint.PlanVerificationError as e:
        tfindings, what = list(e.findings), f"a plan refused at {e.where}"
    dt = time.perf_counter() - t0
    for f in tfindings:
        print(f"[tracelint] {f.format()}")
    print(f"[tracelint] preflight {name}: {len(tfindings)} finding(s) "
          f"({what}) in {dt:.2f}s")
    t0 = time.perf_counter()
    report, pfindings = planlint.lint_plans([name], device=args.device,
                                            mesh=mesh)
    dt = time.perf_counter() - t0
    for f in pfindings:
        print(f"[planlint] {f.format()}")
    row = report[0]
    what = row.get("skipped") or "artifacts " + ", ".join(row["artifacts"])
    print(f"[planlint] preflight {name}: {len(pfindings)} finding(s) "
          f"({what}) in {dt:.2f}s")
    errors = [f for f in (*tfindings, *pfindings) if f.severity == "error"]
    if errors:
        ap.error(f"lint preflight failed with {len(errors)} error "
                 f"finding(s); serve refused (run python -m "
                 f"repro_torch.analysis.lint --backend {name} to inspect)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching through the paged-KV serve "
                    "engine (default: one-shot greedy_generate)")
    ap.add_argument("--batch", type=int, default=4,
                    help="one-shot mode: prompts in the batch")
    ap.add_argument("--backend", default=None, choices=list_backends(),
                    help="integer-GEMM backend for the PTQ linears "
                    "(default: int_dot)")
    ap.add_argument("--path", default=None, choices=list_backends(),
                    help="DEPRECATED alias for --backend")
    ap.add_argument("--w-bits", type=int, default=4, choices=(4, 8))
    ap.add_argument("--fp", action="store_true",
                    help="serve the base config unquantized (bf16 linears, "
                    "float attention, exact KV pool)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="decode attention through the live-page CUDA "
                    "kernel instead of the full-extent gather")
    ap.add_argument("--no-bucket-prefill", action="store_true",
                    help="(--continuous) prefill each request alone at "
                    "batch 1 instead of in bucketed batches")
    ap.add_argument("--no-precompile", action="store_true",
                    help="skip planning every linear before serving "
                    "(planned backends: each plan is built through the "
                    "plan cache as the plans are attached)")
    ap.add_argument("--lint", action="store_true",
                    help="lint the backend's serving programs (tracelint) "
                    "and plan artifacts (planlint) before serving and "
                    "refuse to serve on an error finding")
    ap.add_argument("--mesh", default=None, metavar="AXIS=N[,AXIS=N]",
                    help="serve on a data mesh of N ranks, e.g. 'data=4': "
                    "batch rows (or packed slots) split over the ranks, "
                    "plans placed on the mesh (replicated)")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--arrive-every", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run the "
                    "plain PyTorch path on the CPU)")
    ap.add_argument("--bundle-dir", default=None, metavar="DIR",
                    help="plan-bundle directory for --role")
    ap.add_argument("--role", default=None, choices=("planner", "server"),
                    help="planner: plan once, write bundles to --bundle-dir "
                    "and exit; server: attach plans from --bundle-dir "
                    "instead of planning (zero plan builds, "
                    "fingerprint-checked)")
    ap.add_argument("--watch-weights", default=None, metavar="DIR",
                    help="(--continuous) hot-swap drill: watch DIR for new "
                    "weight checkpoints, re-plan off-thread and swap at a "
                    "step boundary; the launcher writes the new checkpoint "
                    "itself after --swap-after host steps")
    ap.add_argument("--swap-after", type=int, default=3,
                    help="(--watch-weights) host steps before the new "
                    "weights' checkpoint is written")
    ap.add_argument("--swap-seed", type=int, default=1234,
                    help="(--watch-weights) seed of the new weights")
    ap.add_argument("--assert-swap-identity", action="store_true",
                    help="(--watch-weights) exit non-zero unless every "
                    "finished request equals its generation served alone "
                    "on a fresh engine")
    args = ap.parse_args(argv)
    if args.role is not None and not args.bundle_dir:
        ap.error(f"--role {args.role} needs --bundle-dir")
    if args.watch_weights and not args.continuous:
        ap.error("--watch-weights needs --continuous (the hot-swap "
                 "protocol lives on the serve engine)")
    if args.role is not None and args.fp:
        ap.error("plan bundles carry quantized-weight plans; drop --fp")
    mesh = None
    if args.mesh is not None:
        mesh = _mesh_or_ranks(ap, args, argv)
        if mesh is None:
            return None

    name = args.backend or "int_dot"
    if args.path is not None:
        warnings.warn("--path is deprecated; use --backend",
                      DeprecationWarning)
        name = args.path if args.backend is None else name
    if args.lint:
        lint_preflight(ap, name, args, mesh)
    base = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = base if args.fp else serve_config(base, w_bits=args.w_bits,
                                            backend=name)
    model = Model(cfg, device=args.device)
    reason = model.supports_paged()
    if args.continuous and reason is not None:
        ap.error(f"--continuous needs the paged serve path: {reason}")
    params = model.init(args.seed, on_device=True)
    raw_params = params
    backend = get_backend(name)
    planned = not args.fp and backend.needs_plan

    if args.role == "planner":
        from repro_torch.fleet import write_bundles
        try:
            manifest = write_bundles(params, cfg.quant, args.bundle_dir)
        except ValueError as e:
            ap.error(str(e))
        print(f"[planner] {args.bundle_dir}: {manifest['n_files']} bundle "
              f"file(s) over {manifest['n_layers']} layer(s), backend="
              f"{manifest['backend']}, weights="
              f"{manifest['weights_fingerprint'][:12]} "
              f"({manifest['plan_wall_s']:.2f}s plan+compile)")
        return manifest

    from repro_torch.core import plancache
    cache = plancache.default_cache()
    if args.role == "server":
        if not (planned and backend.device_resident):
            ap.error(f"--role server attaches device plan bundles; backend "
                     f"'{name}' does not execute from them")
        from repro_torch.analysis.planlint import PlanVerificationError
        from repro_torch.core.engine import BundleMismatchError
        from repro_torch.fleet import load_bundles, read_manifest
        cache.reset_stats()
        t0 = time.perf_counter()
        try:
            params = load_bundles(params, cfg.quant, args.bundle_dir,
                                  mesh=mesh)
        except (FileNotFoundError, BundleMismatchError,
                PlanVerificationError) as e:
            raise SystemExit(f"[server] bundle refused: {e}")
        builds = cache.stats()["misses"]
        print(f"[server] attached "
              f"{read_manifest(args.bundle_dir)['n_files']} bundle(s) from "
              f"{args.bundle_dir} in {time.perf_counter() - t0:.2f}s | "
              f"plan builds on this cell: {builds}")
        if builds:
            raise SystemExit("[server] bundle attach built plans locally "
                             "— the planner artifact is incomplete")
    elif planned and args.no_precompile:
        misses = cache.stats()["misses"]
        t0 = time.perf_counter()
        params = model.attach_device_plans(params, mesh=mesh)
        print(f"[plan cache] no precompile: attach built "
              f"{cache.stats()['misses'] - misses} plans in "
              f"{time.perf_counter() - t0:.2f}s | {cache!r}")
    elif planned:
        t0 = time.perf_counter()
        stats = model.precompile_plans(params)
        params = model.attach_device_plans(params, mesh=mesh)
        print(f"[plan cache] {stats['plans']} plans over {stats['layers']} "
              f"stacked layer weights in {time.perf_counter() - t0:.2f}s | "
              f"{cache!r}")
    if not args.continuous:
        return generate_oneshot(model, params, args, mesh)
    return serve_continuous(model, params, args, raw_params=raw_params,
                            mesh=mesh)


def _mesh_or_ranks(ap, args, argv):
    """``--mesh``: refuse what this slice does not serve, then either
    start the ranks (none running yet: this process only waits for them,
    and exits with their largest code) and return None, or, inside a
    rank, return the mesh (None on a rank outside it)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as M
    try:
        axes = M.parse_mesh_spec(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    if axes.get("model", 1) > 1:
        ap.error(f"--mesh {args.mesh}: a 'model' axis above 1 (tensor-"
                 f"parallel weights) is not served yet; it is ROADMAP item "
                 f"A10.2")
    if args.watch_weights:
        ap.error("--watch-weights under --mesh: each rank's watcher would "
                 "stage the swap at its own step; the mesh engine swaps "
                 "through swap_params at one step on every rank")
    if args.role == "planner":
        ap.error("--role planner plans once, in one process; drop --mesh")
    if not dist.is_initialized():
        n = 1
        for size in axes.values():
            n *= size
        from repro_torch.launch import serve as entry
        code = M.run_cli_on_mesh(entry.main, list(
            sys.argv[1:] if argv is None else argv), n, args.device)
        if code:
            raise SystemExit(code)
        return None
    mesh = M.make_serve_mesh(axes, device=args.device)
    return mesh if mesh.get_coordinate() is not None else None


if __name__ == "__main__":
    main()
