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
(``Model.supports_paged``), recurrentgemma-9b among them: with
``--continuous`` they are refused with its reason.

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

Meshes, plan bundles, hot swap and the lint preflight of the reference
launcher are not ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, get_reduced
from repro_torch.core.backend import get_backend, list_backends
from repro_torch.launch.specs import serve_config
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


def generate_oneshot(model, params, args):
    """``--batch`` seeded prompts through ``greedy_generate`` over dense
    caches; returns the (batch, gen) tokens on the host."""
    import torch
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda

    cfg = model.cfg
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len)))
    max_len = args.prompt_len + args.gen + 8
    kernels = (transitive_forest, transitive_gemm_cuda, rg_lru_cuda)
    launches0 = [k.launches for k in kernels]
    t0 = time.perf_counter()
    toks = greedy_generate(model, params, {"tokens": tokens},
                           max_len=max_len, n_steps=args.gen).cpu()
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
    return toks


def serve_continuous(model, params, args):
    """Staggered arrivals through ServeEngine; returns the engine."""
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.serve import ServeEngine

    cfg = model.cfg
    ps = args.page_size
    max_len = -(-(args.prompt_len + args.gen) // ps) * ps
    eng = ServeEngine(model, params, n_slots=args.slots, max_len=max_len,
                      page_size=ps, paged_kernel=args.paged_kernel,
                      device=model.device)
    prompts = prefix_sharing_prompts(cfg.vocab, args.requests,
                                     args.prompt_len, args.seed + 1)
    kernels = (transitive_forest, transitive_gemm_cuda, paged_attention)
    launches0 = [k.launches for k in kernels]
    submitted = host_step = 0
    t0 = time.perf_counter()
    while submitted < args.requests or eng.queue or eng.active:
        if (submitted < args.requests
                and host_step >= submitted * args.arrive_every):
            eng.submit(prompts[submitted], args.gen)
            submitted += 1
        eng.step()
        host_step += 1
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
          f"{'paged-kernel' if args.paged_kernel else 'gather'}")
    for r in eng.finished:
        print(f"  req {r.rid}: {r.tokens}")
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching through the paged-KV serve "
                    "engine (default: one-shot greedy_generate)")
    ap.add_argument("--batch", type=int, default=4,
                    help="one-shot mode: prompts in the batch")
    ap.add_argument("--backend", default="int_dot", choices=list_backends(),
                    help="integer-GEMM backend for the PTQ linears")
    ap.add_argument("--w-bits", type=int, default=4, choices=(4, 8))
    ap.add_argument("--fp", action="store_true",
                    help="serve the base config unquantized (bf16 linears, "
                    "float attention, exact KV pool)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="decode attention through the live-page CUDA "
                    "kernel instead of the full-extent gather")
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
    args = ap.parse_args(argv)

    base = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    cfg = base if args.fp else serve_config(base, w_bits=args.w_bits,
                                            backend=args.backend)
    model = Model(cfg, device=args.device)
    reason = model.supports_paged()
    if args.continuous and reason is not None:
        ap.error(f"--continuous needs the paged serve path: {reason}")
    params = model.init(args.seed, on_device=True)
    if not args.fp and get_backend(args.backend).needs_plan:
        from repro_torch.core import plancache
        cache = plancache.default_cache()
        t0 = time.perf_counter()
        stats = model.precompile_plans(params)
        params = model.attach_device_plans(params)
        print(f"[plan cache] {stats['plans']} plans over {stats['layers']} "
              f"stacked layer weights in {time.perf_counter() - t0:.2f}s | "
              f"{cache!r}")
    if not args.continuous:
        return generate_oneshot(model, params, args)
    return serve_continuous(model, params, args)


if __name__ == "__main__":
    main()
