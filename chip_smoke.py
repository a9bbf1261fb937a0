#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA GPU; hold each kernel
against its plain version.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

  0. the card's ``nvidia-smi`` name and power limit;
  1. build all seven CUDA sources from ``src/repro_torch/csrc`` (one
     ``nvcc`` each, in parallel) into ``build/kernels``;
  2. B1, the fused forest kernel from a compact ``ForestPlan``, through
     both its entries ((K, M) int32 and the serving path's (M, K) int8
     rows), against the dense plan's ``run_device``, the compact plan's
     ``forest_plan_plain`` and the exact integer GEMM at smollm-135m's
     four linear shapes x M in {1, 4, 8, 64, 512}, a grouped case, a
     direct-heavy (outlier) plan and a sparse plan with mostly unused
     nodes: exact int32 equality, with kernel / plain / library
     (``torch._int_mm``, M padded to 32) / bound times (the bound from
     the compact plan's bytes), the profiler's device time per call at
     every ungrouped shape, beside B3's and ``torch._int_mm``'s, and the
     (K, M) entry's cost from a DevicePlan;
  3. B2, the paged-attention kernel (one thread block cluster per slot,
     KV head and block of at most 8 query heads), in each of its four
     pool layouts (int8 or exact bf16 pool x int8 or float attention)
     against the gather + attend_cached path at B=4, page_size 16: KV=3,
     G=3, hd=64 (smollm-135m) at max_len 256 and 2048; G=1 hd=128 (KV 32,
     llama1-7b), G=5 (KV 8, qwen3-14b), G=16 (KV 2, chatglm3-6b), G=16
     hd=256 (KV 1, recurrentgemma-9b's heads) and, at KV 2, hd=72 and
     hd=320 (rows not a multiple of 16 bytes, heads above 256) at G=1 and
     G=4, at max_len 256; ragged steps, two calls bit-identical, within
     the bounds of
     ``kernels.paged_attention.agreement``, with kernel / profiler /
     plain / library
     (``scaled_dot_product_attention``, exact float layout) / bound times;
  B3. the doubling-LUT transitive GEMM against its plain version and the
     exact integer GEMM at smollm-135m's four linear shapes x M in {1, 4,
     8, 64, 512} at w_bits 4, one shape at w_bits 8, at w_bits 2 and at
     T=4, a ragged (M, N, K) = (130, 70, 512) case, the grouped
     down-projection (N=576, K=1536, 12 groups of 128) at M=64 and 4, and
     40 extreme-value cases: exact int32 equality, with kernel / plain /
     library (``torch._int_mm``, M padded to 32) / bound times, the
     shared-memory floor of the gathers, the profiler's device time per
     call (one device op per call, asserted) and the K split; then
     llama1-7b's three linear shapes (N, K) = (4096, 4096), (11008,
     4096), (4096, 11008) at M = 4 and 512, exact against the integer
     GEMM, timed beside ``torch._int_mm`` (``check_tgemm_arch``; after
     phase 11b it runs recurrentgemma-9b's four shapes, (4096, 4096),
     (256, 4096), (12288, 4096), (4096, 12288), at M = 4, 512 and 2100;
     moonshot-v1-16b-a3b's attention linears, (2048, 2048), at M = 4 and
     512; llama4-maverick-400b-a17b's attention linears, (5120, 5120) and
     (1024, 5120), and shared expert, (8192, 5120) and (5120, 8192), at M
     = 4; xlstm-125m's (768, 768) and its mLSTM gate projection (8, 768)
     at M = 4 and 512; whisper-tiny's (384, 384), (1536, 384) and (384,
     1536) at M = 4 and 6,000 (the encoder's 4 x 1,500 frames); and
     llama-3.2-vision-90b's (8192, 8192), (1024, 8192), (28672, 8192) and
     (8192, 28672) at M = 4; then B1 at xlstm-125m's two shapes, M = 4
     and 512, exact against its plain versions and the integer GEMM and
     timed as in phase 2 (``check_forest_arch``: the shapes phase 14's
     ``engine_cuda`` run sends through B1));
  B3g. B3 at T outside {4, 8}, through the same kernel at its own
     subtile width (8, or 4 in the unaligned instance where K / groups is
     not a multiple of 4): T in {1, 2, 3, 5, 6, 7, 9, 12, 16, 32} x w_bits
     in {2, 4, 8} and a grouped case, exact, each call one launch of the
     ``tgemm_lut`` instance expected; T=6 and T=5 at K=575 timed;
  B1d. B1 for plans with 9 <= T <= 15: ``engine_cuda`` attaches
     ForestPlans with int16 gathers, each call one launch of the fused
     kernel ``forest_fused16`` (profiler name asserted): a T=9 linear
     (N=1536, K=576) at M in {4, 64}, its ``linear_apply`` equal to
     ``engine_torch``'s; T=12 at smollm-135m's four linear shapes at M=4,
     1536x576 at M=512, the grouped down-projection in 16 groups of 96;
     extreme values at T=12 and T=15; exact against ``run_device``,
     ``forest_plan_plain`` and the integer GEMM; T=9 and the four T=12
     shapes timed (kernel ms, device us, ``torch._int_mm``, the
     function's bound and those with the ForestPlan's and the
     DevicePlan's bytes), ForestPlan and DevicePlan bytes printed;
  B1s. B1 for plans with T >= 16: ``engine_cuda`` packs them into
     SparseForestPlans (each tile's made nodes only, int16 slots), each
     call one launch of ``forest_sparse`` (launch count and profiler name
     asserted): a T=16 linear at N=1536, K=64 (K cut from 576 for
     planning time) at M in {4, 64}, timed (kernel ms, device us,
     ``torch._int_mm``, plain, the function's bound and those with the
     compact plan's and the DevicePlan's bytes) beside the parent's
     two-pass kernel on the same DevicePlan and x; T=16 grouped, 8-bit,
     T=17 grouped and extreme values; exact against ``run_device``,
     ``sparse_forest_plain`` and the integer GEMM; the compact plan at
     least 50x below the DevicePlan's bytes;
  B4. the group-dequant GEMM: its tensor-core instance ``w4a8_wgmma`` at
     (N, K, group) = (1536, 576, 64), (576, 1536, 128) (smollm-135m) and
     (11008, 4096, 128), (4096, 11008, 128) (llama1_7b) x M in {4, 512},
     bit-equal to ``w4a8_gemm_ordered``, within the first-order bound of
     its order from the function in float64, and timed beside
     ``w4a8_dot`` in turns on the same data (device us, kernel ms,
     ``torch._int_mm`` for scale); ``w4a8_dot`` at group 6 and K=32,768
     at M=4; both within the reference's tolerance of the plain version
     except at llama1_7b's M=512, where the outputs beyond it are counted
     (``check_w4a8``);
  B5. the linear recurrence against its plain version at
     recurrentgemma-9b's width D=4096: B=4, S=2048 with (x, a) in
     (float32, float32), (bfloat16, bfloat16), (float16, float16) and
     (float32, bfloat16), and B=1, S=65,536 in float32 (``long_500k``'s
     B=1, S cut from 524,288), each bit-equal and one launch of the
     instance ``launch_plan`` picks (``rg_lru_ring``, TMA into a ring of
     shared-memory stages) by the profiler's name, with kernel / plain
     (not at S=65,536) / bound times and device us per call
     (``check_rg_lru``);
  4. a reduced float32 smollm served through ``ServeEngine`` on the card
     with the forest kernel and with its plain version: tokens equal;
  5. the forest serving path: full-width smollm-135m (30 layers, d_model 576,
     vocab 49152, bf16, random weights from a seed) with W4A8 forest
     linears (``engine_cuda``, compact ForestPlans attached: their bytes
     on the card must be below the int8 weights') and the paged-attention
     kernel, 4 slots, page_size 16, max_len 256, 8 requests of 128-token
     prompts sharing prefixes, 32 tokens each; launch counts of both
     kernels over that run must be > 0 and nothing may be packed during
     it; then the same requests on the plain path (``engine_torch``
     running its own dense DevicePlans through ``run_device``, + gather
     decode) and the share of tokens that agree. From here on the plan
     verifier's gates (``repro_torch.analysis.planlint``) are counted
     (``GateMeter``: artifacts, findings and seconds per ``where``,
     printed after each phase): phase 5's planning must show 210
     ``cache-publish`` verifications, one per cache miss, and no finding;
  6. the LUT serving path: the same model, weights and requests served on
     ``lut_cuda`` (the doubling-LUT kernel) with the paged-attention
     kernel and no plan: over that run B3 and B2 launch, B1 does not, the
     plan cache sees no lookup, and all 256 tokens equal phase 5's;
  8-10. B2's other layouts served at full width (``layout_paths``), the
     same requests: ``--fp`` (bf16, exact pool, float attention), W4A8 on
     ``lut_cuda`` with an int8 pool and float attention, and with an exact
     pool and int8 attention; B2 must launch once per layer per decode
     step; the gather path's token agreement is printed, with the
     teacher-forced logit differences and top-2 margins where the two
     part, and B2 against its plain version on the serving path's own
     inputs (a third run: within the loose bound, asserted);
  11. llama1-7b, the paper's evaluation model, at full width and depth
     (32 layers, d_model 4096, 32/32 heads, hd 128, d_ff 11008, vocab
     32000, untied, bf16, random weights from seed 0 drawn on the card)
     served on ``lut_cuda`` + B2 with phase 5's workload: B3 and B2 (once
     per layer per decode step) launch, B1 does not, the plan cache sees
     no lookup; the same requests on ``int_dot`` + B2 give all 256 tokens
     equal; then the host planning of one q-projection (4096 x 4096, T=8)
     for ``engine_cuda``, timed, with its ForestPlan bytes;
  11b. qwen3-14b (G=5, qk-norm), mistral-nemo-12b (G=4, hd 128 against
     d_model / heads = 160) and chatglm3-6b (G=16, partial RoPE) at their
     published widths, depth cut to 4 layers, the same checks, each
     model freed before the next is built (``dense_paths``);
  12. recurrentgemma-9b at full width and depth (38 layers: 12 x
     (rglru, rglru, attn) + a tail of two rglru, d_model 4096, 16 heads
     over 1 KV head, hd 256, d_ff 12288, vocab 256000 tied, local window
     2048, bf16, random weights from seed 0 drawn on the card) served as
     the reference serves it, through one-shot ``greedy_generate`` over
     dense caches on ``lut_cuda`` (``recurrent_path``): (a) B = 4,
     128-token prompts, 32 tokens; (b) B = 1, a 2,100-token prompt
     (``attend_chunked`` with the window; decode wraps the 2048-slot
     rolling caches), 16 tokens. B5 launches once per RG-LRU block of the
     prefill (26), B3 launches, B1 and B2 do not, the plan cache sees no
     lookup; ``int_dot`` gives every token equal; one block's (a, b) from
     each run through B5 and its plain version, bit-equal, with B5's
     device us per call there; prefill seconds, decode tokens/s and peak
     GiB printed;
  13. moonshot-v1-16b-a3b (MoE: 64 experts top-6, d_ff 1408 each) at
     full width and depth (48 layers, d_model 2048, 16/16 heads, hd 128,
     vocab 163840 tied, bf16 experts, random weights from seed 0 drawn on
     the card) through ``serve_arch`` on phase 5's workload: B3 (the
     attention linears) and B2 (once per layer per decode step) launch,
     B1 does not, the plan cache sees no lookup, ``int_dot`` gives every
     token equal; the init's peak, tokens/s, mean TTFT, the distinct
     experts hit per layer and decode step (with the expert bytes they
     make a step read) and the host syncs inside the model's decode step
     printed;
  13b. llama4-maverick-400b-a17b (128 experts top-1 + a shared expert
     whose W4A8 linears run on B3, 40/8 heads: G=5) at its published
     widths, depth cut to 1 layer (400B parameters do not fit one card),
     the same checks (``moe_paths``; moonshot freed first);
  14. xlstm-125m at full width and depth (12 layers: 6 x (mlstm,
     slstm), d_model 768, 4 heads of 192, no MLP, vocab 50304 tied, bf16,
     random weights from seed 0 drawn on the card) through one-shot
     ``greedy_generate`` (``xlstm_path``): (a) B = 4, 128-token prompts
     (two chunks of the chunkwise mLSTM), 32 tokens on ``lut_cuda``: B3
     launches 6,180 times in the prefill (6 x (5 mLSTM linears + 8 sLSTM
     linears a position + ``w_out``)) and 84 a decode step, B1, B2, B5 do
     not, the plan cache sees no lookup; again on ``engine_cuda`` (84
     linears planned on the host, timed; B1 launches, B3 does not) and
     on ``int_dot``: tokens equal; (b) B = 1, a 200-token prompt (one
     chunk of 200, the reference's fallback), 16 tokens on ``lut_cuda``
     and ``int_dot``: tokens equal;
  15. whisper-tiny at full width and depth (4 encoder layers over 1,500
     seeded frame embeddings, 4 decoder layers of (attn, cross) with the
     GELU MLP after the cross block; float attention, bf16 caches) and
  15b. llama-3.2-vision-90b at its published widths with one super-block
     (4 attn + 1 cross of 100 layers: 90B parameters do not fit one
     card; 1,024 seeded patch embeddings; int8 attention, KV8 self
     caches, bf16 cross caches), both through one-shot ``greedy_generate``
     (``cross_paths``): B = 4, 128-token prompts, 32 tokens on
     ``lut_cuda``, B3 asserted (64 in the prefill and 32 a step; 35 and
     33), B1, B2, B5 not launched, and on ``int_dot``: tokens equal; the
     init peak printed;
  16. training: smollm-135m at full width and depth (bf16, grad_accum 4,
     remat "block", weights drawn on the card) through ``train.loop.train``
     at global batch 32 x 512 tokens: (a) 8 steps straight; (b) the same
     job checkpointing every 2 steps, crashed at step 5 under
     ``run_with_restarts``, resumed at step 4: its last loss within 2e-4
     of (a)'s; no B1-B5 launch (mode ``none`` trains on plain products);
     step time (median of three steps timed after (a)), tokens/s, peak
     memory, losses and one profiled step printed (``train_path``);
  16b. recurrentgemma-9b at its published widths with one super-block and
     the tail (5 of 38 layers: the full depth with AdamW state does not
     fit one card), two train steps at seq 256, batch 8, grad_accum 8: B5
     launches forward (4 a microbatch, + 2 recomputed by remat) and
     backward (``rg_lru_grad``, 4 a microbatch), counted apart; one
     profiled step (B5's device time in it) and B5's forward and backward
     apart at the step's shape; then B5's gradient at the path's shapes (B=4 S=128, B=1 S=2100, D=4096, f32)
     against autograd through its plain version, timed
     (``train_recurrent_path``);
  17. the accuracy example (``examples.quantize_eval``) on the card:
     reduced smollm trained 60 steps (the loss falls by more than 0.5),
     then W8A8 and W4A8 perplexities on ``lut_cuda`` (B3) and
     ``engine_cuda`` (B1) equal to ``int_dot``'s bit for bit, both
     kernels launched (``accuracy_path``);
  18. the live-weight fleet on phase 5's model, plans and workload
     (``fleet_path``, run right after phases 8-10): (a) the 210 linears
     planned into plan bundles (``fleet.write_bundles``, a fresh plan
     cache; seconds, files, bytes), loaded by ``fleet.load_bundles`` with
     no plan-cache lookup, the packed ForestPlans equal phase 5's leaf for
     leaf, phase 5's requests served from them (all 256 tokens equal
     phase 5's), a stale bundle (one weight byte changed) and a damaged
     file (one byte flipped, forced) refused; (b) a hot swap under load:
     4 requests admitted on generation 0, seed-1234 weights written as a
     checkpoint after 3 host steps, a ``WeightWatcher`` + ``ReplanWorker``
     planning all 210 linears off the serving thread while decode goes
     on, 4 requests on generation 1; every request's tokens equal its
     generation served alone on a fresh engine with the same admission
     schedule (``launch.serve.replay``), no plan build, plan-cache build
     or pack on the serving thread, B1 and B2 launched on both
     generations, one generation retired; the host decode step's median
     before, during and after the replan (and served alone), the
     worker's ``build_s``; (c) a structurally different params tree
     raises ``SwapMismatchError`` and a replan whose build raises fires
     ``on_error``: generation 0 serves on, its tokens phase 5's. The
     gates: the load's
     ``bundle-load`` verifies the manifest, every file (its plan and
     DevicePlan, before its SHA-256) and the 7 lowered ForestPlans, 428
     artifacts, no finding (the damaged file is now refused there); the
     replan's 210 ``cache-publish`` and 7 ``swap-staging`` on the
     worker thread; phase 18a's bundles stay for phase 22;
  22. the data-parallel serve cell on the one card (``mesh_path``, right
     after phase 18): two ranks (``launch.mesh.run_ranks``, one ``gloo``
     group: NCCL refuses two ranks on one GPU, so the step's token and
     K/V exchange goes through the host), a ``data=2`` mesh, each rank
     serving smollm-135m at its published widths and all 30 layers on
     ``engine_cuda`` (B1) + B2 with bucketed prefill and phase 5's
     engine settings and requests, its 2 of the 4 slots; plans from
     phase 18a's bundles through ``load_bundles(mesh=)`` (replicated
     DTensor leaves, 0 plan builds and 0 cache lookups on any rank,
     read after the load and again after the serve); all 256 tokens
     equal to phase 5's on every rank, B1 and B2 launched on every rank;
     the backend, each rank's device and slot rows, its launches, the
     packed decode's placements, ``mesh_decode_report``'s line over the
     slots (``mesh_serve_report``: the requests and tokens served) and
     seconds printed; then ``python -m
     repro_torch.analysis.lint --mesh data=2 --backend engine_cuda
     --device cuda`` across the two ranks: exit 0, 0 findings,
     ``sharding-integrity`` evaluated on the decode program;
  19. the paper's evaluation and the launcher flags (``paper_path``): (a)
     the quickstart example on the card, its one B3 launch bit-equal to
     the int64 GEMM and to B3's plain version; (b) the serve_lm example
     on the card, then its W4A8 model again on ``lut_cuda``, tokens equal
     to its ``int_dot`` run's; (c) ``repro_torch.paper.run``'s six
     sections (the modelled accelerators of Figs. 9-14, computed on the
     host), the Fig. 10 llama1-7b TA4 speedups within the reference's
     bands; (d) ``launch.serve.main`` on smollm-135m at full width and
     depth with phase 5's sizes on ``lut_cuda``, with
     ``--no-bucket-prefill`` (tokens equal) and with ``--path engine_cuda
     --no-precompile --lint`` on a fresh plan cache (the warning caught,
     the tracelint preflight's 7 programs on the card and the plan
     preflight with no finding, the preflight's plans in a cache of their
     own, all 210 serving plans built inside attach and verified at
     ``cache-publish``, tokens equal); (e) a
     greedy loop over ``make_prefill`` / ``make_decode_step`` at full
     width on ``lut_cuda``, tokens equal to ``greedy_generate``'s;
  20. the plan verifier on the card (``verifier_path``): (a)
     ``lint_plans(["engine_torch", "engine_cuda"])`` on ``cuda``, no
     finding; (b) a 1-layer smollm-135m at full width: the up
     projection's unstacked ForestPlan (1536 x 576, T=8) on the card, a
     copy with one gathered node set FOREST_UNUSED run through B1 differs
     from the exact GEMM (the clean plan equals it), the copy and one
     with two gathers swapped refused at ``cache-lowering``
     (``forest-gathers``, ``plan-forest-agreement``), a generation
     carrying the copy refused at ``swap-staging`` with nothing staged
     and the engine's tokens unchanged; (c) its 7 plans as bundles, one
     truncated, refused at ``bundle-load`` (``bundle-file``) before
     ``_sha256`` reads it;
  21. the program half of the analysis on the card (``tracelint_path``):
     the walker's op spellings on the card's torch (cuda and CPU), RoPE's
     frequencies equal to the old formula's; (a) ``python -m
     repro_torch.analysis.lint --backend engine_cuda --backend lut_cuda
     --plans --budgets --device cuda`` exit 0, ``paged-attention`` with
     one ``kernel:B2`` site a layer, ``forest`` one ``kernel:B1`` site,
     the live-page budget held by (c), not evaluated; (b) both backends' programs at smollm-135m's published widths (2
     layers): 0 findings, the kernel sites, seconds; (c) B2 bit-identical
     with every row it has no business reading poisoned, in all four
     layouts, and the oracle paged decode's pool reads growing past the
     live-page budget; (d) ``no-host-callback`` on an ``.item()``, a
     ``.cpu()`` and a ``torch.tensor``, ``swap_trace_count`` 1 aligned
     and 2 widened on ``engine_torch``;
  7. the public kernel API (``repro_torch.kernels.ops``): each of its
     five functions once on the card at a serving shape, plus B3 at T=6
     and T=16 (counted apart), B1 from a T=9 and a T=15 plan (the fused
     int16 kernel), a T=16 plan (``forest_sparse``) and a T=16 plan too
     large for a compact table (the two-pass kernel) and B5 over
     float64, every kernel launched, each result equal to (or, B4 and f32
     B5, within tolerance of) its plain version.

Every launch count in the JSON line is read from the run of the path
that drives the kernel (B1: phase 5; B2: phase 6 for the int8 pool with
int8 attention, phases 8-10 for the other layouts; B3: phase 6; B4, B5,
B3 at T outside {4, 8} and B1 at T > 8: phase 7), with the counts set to
0 just before it; B2's int8 entry and B3's also list their launches in
phases 11, 11b, 13 and 13b (B3's and B5's in phase 12's two runs too,
B3's in phases 14-15b and 17, B1's in phase 14's ``engine_cuda`` run and
phase 17, B5's forward and backward in phase 16b, B1's and B2's int8
entry in phase 18's three runs, B1's, B2's int8 entry and B3's in
phase 19's runs, B1's and B2's int8 entry in phase 20 and in each
rank of phase 22) under ``launches_in_other_phases``
(phase 18's numbers under B1's ``fleet_phase``), and B3's entry the one-shot phases'
prefill seconds, decode tokens/s and peaks under ``oneshot_phases``;
launches made to compare a kernel with its plain version are not
counted. Each phase's seconds are printed (``[seconds]``). The line
before the last is that JSON object of per-kernel numbers; the last line
is ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor rate
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor rate
SCALAR_OPS_PER_S = 67e12           # H100 SXM float32 rate outside tensor
                                   # cores (132 SMs x 128 lanes x 2 x
                                   # 1.98 GHz: it counts an FMA as two
                                   # operations), the table's closest row
                                   # to the forest's and B3's scalar int32
                                   # work; one int32 add or shared-memory
                                   # gather is held to it as one operation,
                                   # so the operations bound is optimistic
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9   # one 128-byte shared-memory
                                        # wavefront per SM per clock
SHAPES = ((576, 576), (192, 576), (1536, 576), (576, 1536))
MS = (1, 4, 8, 64, 512)


def cuda_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of ``fn`` per call (CUDA events around each call),
    with the 50 MB L2 flushed before every call as the serving loop, which
    streams ~58 MB of compact plans and ~106 MB of weights per step, would
    find it."""
    import torch
    for _ in range(warmup):
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


def bound_ms(n_bytes, n_ops, ops_rate):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_us(fn, kernels=("forest_narrow", "forest_wide"), iters=20):
    """Device time per call of ``fn`` from ``torch.profiler``: (every
    device op of the call, the ops whose name holds one of ``kernels``
    alone: no memset) in microseconds, and the device ops per call. Read
    through ``repro_torch.launch.device_events``, which takes a read only
    when it holds every launch."""
    from repro_torch.launch.device_events import device_events
    events = device_events(fn, iters)
    total = sum(e.self_device_time_total for e in events) / iters
    kernel = sum(e.self_device_time_total for e in events
                 if any(name in e.key for name in kernels))
    kernel /= iters
    return total, kernel, sum(e.count for e in events) / iters


def kernel_names(fn):
    """The names of the device kernels one call of ``fn`` runs (the
    profiler's, template arguments included)."""
    from repro_torch.launch.device_events import kernel_names as names
    return names(fn)


def _forest_weights(pattern, n, k, rng):
    """int4 weights: random, or the planner tests' direct-heavy and sparse
    patterns (tests/test_torch_planner.py::_weights)."""
    import numpy as np
    if pattern == "outlier_heavy":
        return np.where(rng.random((n, k)) < 0.9, 7, -8)
    if pattern == "single_row":
        w = np.zeros((n, k), dtype=np.int64)
        w[0] = rng.integers(-8, 8, size=k)
        return w
    return rng.integers(-8, 8, size=(n, k))


def _forest_ops(fplan, m):
    """This plan's adds: one per level node, popcount per direct node, one
    per APE gather, per column."""
    import torch
    from repro_torch.core.engine import FOREST_DIRECT
    t = fplan.t
    prod = fplan.producer.long()
    steps = int((prod < t).sum())
    direct = prod == FOREST_DIRECT
    nodes = torch.arange(1 << t, device=prod.device)
    pop = ((nodes[:, None] >> torch.arange(t, device=prod.device)) & 1).sum(1)
    direct_adds = int((direct * pop[None]).sum())
    return (steps + direct_adds + fplan.rows.numel()) * m


def _forest_bound(fplan, m, x_bytes):
    """Bytes: the compact plan, x and the int32 output, each once.
    Operations: :func:`_forest_ops`."""
    n_bytes = fplan.nbytes() + x_bytes + fplan.n * fplan.groups * m * 4
    return bound_ms(n_bytes, _forest_ops(fplan, m), SCALAR_OPS_PER_S)


def _forest_exact(w, dplan, fplan, x, qx, g=1):
    """Both entries of B1 on ``x`` (K, M) int32 and its int8 rows ``qx``
    against the dense plan's plain version (``run_device``), the compact
    plan's (``forest_plan_plain``) and the integer GEMM (per group where
    ``g`` > 1): (the (K, M) entry's output, max |diff|)."""
    import torch
    from repro_torch.core.backend import int_matmul
    from repro_torch.core.engine import forest_plan_plain
    from repro_torch.kernels.transitive_forest import (
        forest_plain, transitive_forest, transitive_forest_rows)
    got = transitive_forest(fplan, x)
    got_rows = transitive_forest_rows(fplan, qx)
    want = forest_plain(dplan, x)
    want_compact = forest_plan_plain(fplan, x)
    if g == 1:
        gemm = int_matmul(w, x)
        rows_as_km = got_rows.T
    else:
        k = x.shape[0]
        kg = k // g
        gemm = torch.stack([int_matmul(w[:, i * kg:(i + 1) * kg],
                                       x[i * kg:(i + 1) * kg])
                            for i in range(g)], dim=1)
        rows_as_km = got_rows.permute(2, 1, 0)
    torch.cuda.synchronize()
    return got, max(int((a.long() - b.long()).abs().max())
                    for a, b in ((got, want), (got, want_compact),
                                 (got, gemm), (rows_as_km, want)))


def check_forest(flush):
    """B1, the fused kernel from a compact ForestPlan, against the dense
    plan's plain version (``run_device``), the compact plan's
    (``forest_plan_plain``) and the exact GEMM, through both entries;
    returns the JSON entry (the row entry the serving path calls, timed at
    the decode shape N=1536, K=576, M=4). At every ungrouped shape it also
    prints the profiler's device time per call of B1 beside B3's and
    ``torch._int_mm``'s on the same inputs, and
    at the decode shape what the (K, M) entry costs from a DevicePlan (the
    route of ``kernels.ops``: packed at its first call)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (FOREST_DIRECT, FOREST_UNUSED,
                                         BatchedTransitiveEngine,
                                         compile_plan, forest_plan_plain,
                                         pack_forest_plan)
    from repro_torch.kernels.transitive_forest import (
        transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    rng = np.random.default_rng(0)
    cases = [(n, k, m, 1, "random") for n, k in SHAPES for m in MS]
    cases += [(576, 576, 64, 4, "random"),     # grouped: 4 groups of 144
              (48, 576, 4, 1, "outlier_heavy"),
              (1536, 576, 64, 1, "single_row")]
    plans, entry, worst = {}, None, 0
    for n, k, m, g, pattern in cases:
        if (n, k, g, pattern) not in plans:
            w = _forest_weights(pattern, n, k, rng)
            plan = BatchedTransitiveEngine(4, 8).plan(w, groups=g)
            dplan = compile_plan(plan, device="cuda")
            plans[(n, k, g, pattern)] = (torch.from_numpy(w).cuda(), dplan,
                                         pack_forest_plan(dplan))
        w, dplan, fplan = plans[(n, k, g, pattern)]
        x = torch.randint(-128, 128, (k, m), dtype=torch.int32,
                          device="cuda")
        qx = x.T.to(torch.int8).contiguous()
        got, err = _forest_exact(w, dplan, fplan, x, qx, g)
        worst = max(worst, err)
        if err:
            raise AssertionError(f"forest kernel != plain at N={n} K={k} "
                                 f"M={m} G={g} {pattern}: max |diff| {err}")
        r_ms = cuda_ms(lambda: transitive_forest_rows(fplan, qx), flush)
        k_ms = cuda_ms(lambda: transitive_forest(fplan, x), flush)
        p_ms = cuda_ms(lambda: forest_plan_plain(fplan, x), flush, iters=5,
                       warmup=1)
        if g == 1:
            xm = torch.zeros((max(-(-m // 8) * 8, 32), k),
                             dtype=torch.int8, device="cuda")
            xm[:m] = qx
            w8t = w.to(torch.int8).T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, w8t), flush)
        else:
            lib_ms = None
        b_ms, b_by = _forest_bound(fplan, m, qx.numel())
        prod = fplan.producer
        if pattern == "outlier_heavy" and not (prod == FOREST_DIRECT).any():
            raise AssertionError("the outlier-heavy plan has no direct node")
        if pattern == "single_row" and not (
                prod == FOREST_UNUSED).float().mean() > 0.5:
            raise AssertionError("the sparse plan is not mostly unused")
        lib_txt = "null" if lib_ms is None else f"{lib_ms:.4f}"
        extra = ""
        if g == 1 and pattern == "random":
            tot, ker, _ = device_us(
                lambda: transitive_forest_rows(fplan, qx))
            w8 = w.to(torch.int8)
            b3, _, _ = device_us(
                lambda: transitive_gemm_cuda(qx, w8, w_bits=4),
                kernels=("tgemm_lut",))
            mm, _, _ = device_us(lambda: torch._int_mm(xm, w8t), kernels=())
            extra = (f" | profiler device us/call: {tot:.2f} "
                     f"(kernel {ker:.2f}); B3 {b3:.2f}; _int_mm {mm:.2f}")
        print(f"[B1] N={n} K={k} M={m} G={g} {pattern} (direct "
              f"{int((prod == FOREST_DIRECT).sum())}, unused "
              f"{int((prod == FOREST_UNUSED).sum())} of {prod.numel()} "
              f"nodes): exact | kernel_ms={r_ms:.4f} (row entry; (K, M) "
              f"entry {k_ms:.4f}) plain_ms={p_ms:.4f} library_ms={lib_txt} "
              f"bound_ms={b_ms:.6f} ({b_by}; compact plan {fplan.nbytes()} "
              f"B, dense {dplan.nbytes()} B){extra}")
        if (n, k, m, g, pattern) == (1536, 576, 4, 1, "random"):
            fresh = compile_plan(BatchedTransitiveEngine(4, 8).plan(
                w.cpu().numpy()), device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = transitive_forest(fresh, x)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(first, got):
                raise AssertionError("the (K, M) entry from a DevicePlan "
                                     "differs from its ForestPlan's")
            later_ms = cuda_ms(lambda: transitive_forest(fresh, x), flush)
            print(f"[B1] N={n} K={k} M={m} (K, M) entry from a DevicePlan: "
                  f"first call (packs) {first_ms:.2f} ms, later calls "
                  f"{later_ms:.4f} ms")
            entry = {"ms": r_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "shape": "N=1536 K=576 M=4 (decode, MLP up/gate), "
                              "row entry"}
    entry["max_abs_err"] = worst
    return entry


def check_forest_arch(flush, arch, shapes, ms):
    """B1 at an architecture's linear shapes ((N, K, role), T=8, w_bits 4,
    ungrouped, as ``engine_cuda`` plans them) x ``ms``: both entries exact
    against the dense plan's ``forest_plain``, the compact plan's
    ``forest_plan_plain`` and the integer GEMM, as in :func:`check_forest`;
    the row entry timed (kernel ms, L2 flushed; plain ms; the profiler's
    device us beside ``torch._int_mm``'s) with the bound from the compact
    plan's bytes. Returns ({shape: numbers}, worst |diff|)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, forest_plan_plain,
                                         pack_forest_plan)
    from repro_torch.kernels.transitive_forest import transitive_forest_rows
    rng = np.random.default_rng(5)
    out, worst = {}, 0
    for n, k, role in shapes:
        wn = _forest_weights("random", n, k, rng)
        dplan = compile_plan(BatchedTransitiveEngine(4, 8).plan(wn),
                             device="cuda")
        fplan = pack_forest_plan(dplan)
        w = torch.from_numpy(wn).cuda()
        for m in ms:
            x = torch.randint(-128, 128, (k, m), dtype=torch.int32,
                              device="cuda")
            qx = x.T.to(torch.int8).contiguous()
            _, err = _forest_exact(w, dplan, fplan, x, qx)
            worst = max(worst, err)
            tag = f"{arch} {role} N={n} K={k} M={m} T=8"
            if err:
                raise AssertionError(f"B1 at {tag}: max |diff| {err} from "
                                     f"its plain versions")
            call = (lambda: transitive_forest_rows(fplan, qx))
            r_ms = cuda_ms(call, flush)
            p_ms = cuda_ms(lambda: forest_plan_plain(fplan, x), flush,
                           iters=5, warmup=1)
            dev, ker, _ = device_us(call)
            xm = torch.zeros((max(-(-m // 8) * 8, 32), k), dtype=torch.int8,
                             device="cuda")
            xm[:m] = qx
            w8t = w.to(torch.int8).T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, w8t), flush)
            b_ms, b_by = _forest_bound(fplan, m, qx.numel())
            print(f"[B1 {arch}] {tag}: exact | kernel_ms={r_ms:.4f} (row "
                  f"entry) device us/call {dev:.2f} (kernel {ker:.2f}) "
                  f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} (_int_mm) "
                  f"bound_ms={b_ms:.6f} ({b_by}; compact plan "
                  f"{fplan.nbytes()} B)")
            out[f"N={n} K={k} M={m}"] = {
                "ms": r_ms, "device_us": dev, "kernel_us": ker,
                "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms,
                "bound_by": b_by}
    return out, worst


# B2's four pool layouts (kernels/paged_attention.py LAYOUTS): the JSON
# name suffix, (quant_attention, kv_cache_bits) and the pool dtype checked
ATTN_LAYOUTS = {0: ("kv8-int8attn", True, 8), 1: ("kv16-int8attn", True, 16),
                2: ("kv16-float", False, 16), 3: ("kv8-float", False, 8)}


def _attn_pool(layout, shp, gen):
    import torch
    if ATTN_LAYOUTS[layout][2] == 8:
        return {"k": torch.randint(-128, 128, shp, generator=gen,
                                   device="cuda", dtype=torch.int8),
                "v": torch.randint(-128, 128, shp, generator=gen,
                                   device="cuda", dtype=torch.int8),
                "ks": torch.rand(shp[:-1] + (1,), generator=gen,
                                 device="cuda") * 0.02 + 1e-3,
                "vs": torch.rand(shp[:-1] + (1,), generator=gen,
                                 device="cuda") * 0.02 + 1e-3}
    return {"k": torch.randn(shp, generator=gen, device="cuda")
            .to(torch.bfloat16),
            "v": (torch.randn(shp, generator=gen, device="cuda") * 2)
            .to(torch.bfloat16)}


def _attn_bound(layout, pool, table, steps, q, max_len, ps):
    """Bytes: the live lanes' K and V rows (+ their f32 scales in an int8
    pool; an exact pool under int8 attention also reads the live pages'
    other V rows and, where the table has dead entries, page 0's, for the
    |V| max), q, the page table and steps read once, the output written
    once. Operations: 4 * G * hd per live lane and KV head (two dots),
    against the int8 tensor rate (int8 attention), the bf16 one (the bf16
    exact pool) or the f32 scalar one (the int8 pool's f32 float layout)."""
    import torch
    b, pps = table.shape
    _, _, kv, hd = pool["k"].shape
    g = q.shape[2] // kv
    esz = pool["k"].element_size()
    live = int((torch.clamp(steps + 1, max=max_len)).sum())
    n_bytes = q.numel() * q.element_size() + table.numel() * 4 + b * 4
    if layout in (0, 3):
        n_bytes += live * kv * (2 * hd + 2 * 4)
    elif layout == 1:
        pages = [min(int(s) // ps + 1, pps) for s in steps]
        v_rows = sum(n * ps for n in pages) + ps * sum(n < pps for n in pages)
        n_bytes += (live + v_rows) * kv * hd * esz
    else:
        n_bytes += 2 * live * kv * hd * esz
    out_esz = esz if layout == 2 else 4
    n_bytes += b * kv * g * hd * out_esz
    n_ops = live * kv * g * hd * 4
    rate = {0: INT8_OPS_PER_S, 1: INT8_OPS_PER_S, 2: BF16_OPS_PER_S,
            3: SCALAR_OPS_PER_S}[layout]
    return bound_ms(n_bytes, n_ops, rate)


def _sdpa_ms(q, pool, table, steps, max_len, scale, flush):
    """The library yardstick of layout 2: one
    ``scaled_dot_product_attention`` call over the gathered pages (K and V
    gathered and repeated to every query head beforehand, untimed), the
    lanes past each step masked."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.attention import _gather_pages
    b, _, h, hd = q.shape
    kv = pool["k"].shape[2]
    k = _gather_pages(pool["k"], table).repeat_interleave(h // kv, dim=2)
    v = _gather_pages(pool["v"], table).repeat_interleave(h // kv, dim=2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lanes = torch.arange(k.shape[2], device=q.device)
    mask = (lanes[None, :] < torch.clamp(steps.long() + 1, max=max_len)
            [:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()
    return cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=scale), flush)


# B2's head shapes (KV heads, query heads per KV head, head dim): smollm-135m
# (timed at max_len 256 and 2048, the JSON line's entries) and, at max_len
# 256, the dense architectures' and recurrentgemma-9b's
ATTN_SHAPES = ((3, 3, 64, "smollm-135m"), (32, 1, 128, "llama1-7b"),
               (8, 5, 128, "qwen3-14b"), (2, 16, 128, "chatglm3-6b"),
               (1, 16, 256, "recurrentgemma-9b"),
               (2, 1, 72, "any hd: 72, G=1"), (2, 4, 72, "any hd: 72, G=4"),
               (2, 1, 320, "any hd: 320, G=1"),
               (2, 4, 320, "any hd: 320, G=4"))


def check_attention(flush):
    """B2 in each of its four pool layouts against its plain version at
    B=4, page_size 16, with ragged steps and dead table entries reading
    page 0 (which holds data), within the bounds of
    ``kernels.paged_attention.agreement`` (at most ROW_BUDGET rows beyond
    the tight bound, none beyond the loose one), two calls bit-identical,
    at each of ``ATTN_SHAPES``: smollm-135m's (KV=3, G=3, hd=64) at
    max_len 256 and 2048; llama1-7b's G=1 hd=128 (KV 32), qwen3-14b's G=5
    (KV 8), chatglm3-6b's G=16 (KV 2, two blocks of 8 query heads per KV
    head), recurrentgemma-9b's G=16 hd=256 (KV 1) and hd=72 and hd=320
    at G=1 and G=4 (KV 2) at max_len 256.
    Layout 0 is compared with the plain version on the card, the others
    with it on CPU copies. Each shape prints kernel ms (event-timed, L2
    flushed), the profiler's device us per call, plain ms, library ms
    (layout 2: ``scaled_dot_product_attention`` over the gathered pages)
    and the bytes bound. Returns the JSON entry per layout (smollm-135m
    at max_len 256, the main path's extent), the other shapes' numbers
    under ``shapes``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import (LAYOUTS, ROW_BUDGET,
                                                     agreement, launch_plan,
                                                     paged_attention,
                                                     paged_attention_plain)
    from repro_torch.launch.specs import serve_config
    base = serve_config(get_config("smollm_135m"))
    names = {code: name for code, name in LAYOUTS.values()}
    b, ps = 4, 16
    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = {}
    runs = [(shape, max_len) for shape in ATTN_SHAPES
            for max_len in ((256, 2048) if shape == ATTN_SHAPES[0]
                            else (256,))]
    for layout, (tag, quant, _) in ATTN_LAYOUTS.items():
        cfg = base.replace(quant_attention=quant)
        worst, shapes = 0.0, {}
        for (kv, g, hd, arch), max_len in runs:
            pps = max_len // ps
            n_pages = b * pps + 1
            pool = _attn_pool(layout, (n_pages, ps, kv, hd), gen)
            steps = torch.tensor([0, 17, max_len // 2, max_len - 1],
                                 dtype=torch.int32, device="cuda")
            table = torch.zeros((b, pps), dtype=torch.int32, device="cuda")
            nxt = 1
            for s in range(b):
                live = int(steps[s]) // ps + 1
                table[s, :live] = torch.arange(nxt, nxt + live)
                nxt += live
            q = torch.randn((b, 1, kv * g, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            scale = hd ** -0.5
            got = paged_attention(q, pool, table, steps, cfg, scale)
            again = paged_attention(q, pool, table, steps, cfg, scale)
            if layout == 0:
                want = paged_attention_plain(q, pool, table, steps, cfg,
                                             scale)
            else:
                want = paged_attention_plain(
                    q.cpu(), {n: a.cpu() for n, a in pool.items()},
                    table.cpu(), steps.cpu(), cfg, scale).cuda()
            torch.cuda.synchronize()
            agree = agreement(got, want, pool, table, steps, cfg, q=q,
                              scale=scale)
            err = agree["max_abs_err"]
            worst = max(worst, err)
            same = torch.equal(got, again)
            ok = (got.dtype == want.dtype and torch.isfinite(got).all()
                  and agree["rows_beyond"] <= ROW_BUDGET
                  and agree["worst_loose"] <= 1 and same)
            if not ok:
                raise AssertionError(
                    f"paged attention kernel vs plain, {names[layout]}, "
                    f"{arch}'s KV={kv} G={g} hd={hd}, "
                    f"max_len={max_len}: {agree} (at most {ROW_BUDGET} "
                    f"rows beyond the tight bound, worst_loose <= 1; dtypes "
                    f"{got.dtype}, {want.dtype}; two calls bit-identical: "
                    f"{same})")
            plan = launch_plan(pps, ps, g, hd, pool["k"].element_size(),
                               layout in (0, 3), quant)
            call = (lambda: paged_attention(q, pool, table, steps, cfg,
                                            scale))
            k_ms = cuda_ms(call, flush)
            dev, ker, ops = device_us(call, kernels=("paged_decode",))
            p_ms = cuda_ms(lambda: paged_attention_plain(
                q, pool, table, steps, cfg, scale), flush)
            lib_ms = (_sdpa_ms(q, pool, table, steps, max_len, scale, flush)
                      if layout == 2 else None)
            b_ms, b_by = _attn_bound(layout, pool, table, steps, q,
                                     max_len, ps)
            lib_txt = "null" if lib_ms is None else f"{lib_ms:.4f} (SDPA)"
            print(f"[B2 {names[layout]}] {arch}: B={b} KV={kv} G={g} "
                  f"hd={hd} page_size={ps} max_len={max_len} pool "
                  f"{pool['k'].dtype} steps={steps.tolist()}: max_abs_err="
                  f"{err:.3e} (max|out| {float(want.float().abs().max()):.3e}"
                  f", two calls bit-identical"
                  f", out {got.dtype}; rows beyond the tight bound "
                  f"{agree['rows_beyond']}/{agree['rows']}, worst "
                  f"|diff| / loose bound {agree['worst_loose']:.2e}) | "
                  f"kernel_ms={k_ms:.4f} device us/call "
                  f"{dev:.2f} (kernel {ker:.2f}, {ops:.0f} ops) plain_ms="
                  f"{p_ms:.4f} library_ms={lib_txt} bound_ms={b_ms:.6f} "
                  f"({b_by}) | cluster {plan.cluster}, {plan.pages_per_rank} "
                  f"pages per rank, {plan.chunk_rows} rows per chunk, "
                  f"{plan.head_blocks} block(s) of {plan.heads} query "
                  f"heads per KV head, {plan.smem} B shared memory per "
                  f"block")
            row = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib_ms,
                   "device_us": dev, "kernel_us": ker, "max_abs_err": err,
                   "shape": f"B=4 KV={kv} G={g} hd={hd} ps=16 max_len="
                            f"{max_len}, pool "
                            f"{str(pool['k'].dtype).removeprefix('torch.')}"}
            if arch == ATTN_SHAPES[0][3] and max_len == 256:
                entries[layout] = dict(row, layout=names[layout])
            elif max_len == 256:
                shapes[arch] = row
        entries[layout]["max_abs_err"] = worst
        entries[layout]["shapes"] = shapes
    return entries


def _tgemm_bound(m, n, k, w_bits, groups):
    """The function's work at its own K, whatever subtile width the kernel
    runs. Bytes: x and w int8 read once, the int32 output written once.
    Operations (data-independent): the transitive product at the
    nibble-LUT granularity (the reference's split LUT), per group of 4
    activations of a row, one 16-entry LUT by doubling (15 adds), and per
    (row, column, plane) one gather and one add; K / 4 such groups, a
    fraction where K is not a multiple of 4, against the scalar rate.
    Returns (bound ms, what bounds it) of those two, and the design's
    shared-memory floors at the same K: the gathers' bytes over
    SMEM_BYTES_PER_S at 2 B per (row, gather) (two rows per 32-bit LUT
    word) and at the previous layout's 4 B."""
    nib = k / 4
    n_bytes = m * k + n * k + m * groups * n * 4
    n_ops = m * nib * 15 + m * n * nib * w_bits * 2
    gathers = m * n * nib * w_bits
    b_ms, b_by = bound_ms(n_bytes, n_ops, SCALAR_OPS_PER_S)
    return (b_ms, b_by, gathers * 2 / SMEM_BYTES_PER_S * 1e3,
            gathers * 4 / SMEM_BYTES_PER_S * 1e3)


def check_tgemm(flush):
    """B3 vs its plain version and the exact GEMM; returns the JSON entry
    (timed at the decode shape N=1536, K=576, M=4, w_bits 4, T=8).

    Every timed case also prints the profiler's device time per call of
    B3 (all device ops of the call, and the kernel alone) beside
    ``torch._int_mm``'s, and asserts that the call is one device op (no
    memset: the K split is reduced inside a thread block cluster), and
    the split it ran. Extreme-value cases (activations -128 or 127
    against weights -2^(S-1) or 2^(S-1) - 1, w_bits 2, 4, 5, 6, 8; T=8 at
    K=576, width 8, and T=4 at K=580, width 4) push the kernel's packed
    16-bit LUT halves to their limits (0 and the flush schedule's bound)
    in both widths' instances (asserted by kernel name); they are checked,
    not timed."""
    import torch
    from repro_torch.core.backend import int_matmul
    from repro_torch.kernels.transitive_gemm import (k_split, lut_width,
                                                     transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = [(n, k, m, 4, 8, 1, None) for n, k in SHAPES for m in MS]
    cases += [(1536, 576, 64, 8, 8, 1, None), (1536, 576, 64, 2, 8, 1, None),
              (1536, 576, 64, 4, 4, 1, None), (70, 512, 130, 4, 8, 1, None),
              (576, 1536, 64, 4, 8, 12, None), (576, 1536, 4, 4, 8, 12, None)]
    cases += [(1536, 576 if t == 8 else 580, 64, bits, t, 1, (a, b))
              for bits in (2, 4, 5, 6, 8) for t in (4, 8)
              for a in (-128, 127) for b in ("lo", "hi")]
    entry, worst, extremes = None, 0, 0
    for n, k, m, w_bits, t, groups, fill in cases:
        lim = 1 << (w_bits - 1)
        if fill is None:
            w = torch.randint(-lim, lim, (n, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            x = torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
        else:
            w = torch.full((n, k), -lim if fill[1] == "lo" else lim - 1,
                           device="cuda", dtype=torch.int8)
            x = torch.full((m, k), fill[0], device="cuda", dtype=torch.int8)
        kw = dict(w_bits=w_bits, t=t, groups=groups)
        got = transitive_gemm_cuda(x, w, **kw)
        kg = k // groups
        gemm = torch.stack([int_matmul(x[:, i * kg:(i + 1) * kg],
                                       w[:, i * kg:(i + 1) * kg].T)
                            for i in range(groups)], dim=1)
        want = transitive_gemm_plain(x, w, **kw) if t <= 16 else gemm
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max()),
                  int((got.long() - gemm.long()).abs().max()))
        worst = max(worst, err)
        width = lut_width(k, groups)[0]
        split = k_split(m, n, k, groups, width, sms)
        tag = (f"N={n} K={k} M={m} w_bits={w_bits} T={t} G={groups}"
               f" width={width} ksplit={split}")
        if fill is not None:
            tag += f" x={fill[0]} w={fill[1]}"
        if err:
            raise AssertionError(f"transitive_gemm kernel != plain at {tag}:"
                                 f" max |diff| {err}")
        if fill is not None:
            names = kernel_names(lambda: transitive_gemm_cuda(x, w, **kw))
            instance = f"tgemm_lut<{width}, 16, {w_bits}, false>"
            if len(names) != 1 or instance not in names[0]:
                raise AssertionError(f"{tag} ran {names}, not one "
                                     f"{instance}")
            extremes += 1
            continue
        k_ms = cuda_ms(lambda: transitive_gemm_cuda(x, w, **kw), flush)
        p_ms = cuda_ms(lambda: transitive_gemm_plain(x, w, **kw), flush)
        tot, ker, ops = device_us(lambda: transitive_gemm_cuda(x, w, **kw),
                                  kernels=("tgemm_lut",))
        if ops != 1:
            raise AssertionError(f"B3 at {tag} ran {ops} device ops per "
                                 f"call, not 1")
        if groups == 1 and n % 8 == 0 and k % 8 == 0:
            xm = torch.zeros((max(-(-m // 8) * 8, 32), k),
                             dtype=torch.int8, device="cuda")
            xm[:m] = x
            wt = w.T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, wt), flush)
            mm, _, _ = device_us(lambda: torch._int_mm(xm, wt), kernels=())
            lib_txt = f"{lib_ms:.4f} (device us {mm:.2f})"
        else:
            lib_ms, lib_txt = None, "null"
        b_ms, b_by, smem_ms, smem_old_ms = _tgemm_bound(m, n, k, w_bits,
                                                        groups)
        floor = max((b_ms, b_by), (smem_ms, "shared-memory bytes"))
        print(f"[B3] {tag}: exact | kernel_ms={k_ms:.4f} device us/call "
              f"{tot:.2f} (kernel {ker:.2f}, {ops:.0f} op) plain_ms="
              f"{p_ms:.4f} library_ms={lib_txt} bound_ms={b_ms:.6f} "
              f"({b_by}) | shared-memory floor {smem_ms:.6f} ms (4 B "
              f"layout {smem_old_ms:.6f}) -> bound by {floor[1]}")
        if (n, k, m, w_bits, t, groups) == (1536, 576, 4, 4, 8, 1):
            entry = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms,
                     "device_us": tot,
                     "shape": "N=1536 K=576 M=4 w_bits=4 T=8 (decode, "
                              "MLP up/gate)"}
    print(f"[B3] {extremes} extreme-value cases exact")
    entry["max_abs_err"] = worst
    return entry


LLAMA_SHAPES = ((4096, 4096, "q/k/v/o"), (11008, 4096, "up/gate"),
                (4096, 11008, "down"))
# recurrentgemma-9b's linears: the RG-LRU block's five and the attention
# block's q/o at 4096 x 4096, k/v over its one KV head of 256, the MLP's
RGEMMA_SHAPES = ((4096, 4096, "rglru x/gate/r/i/out, attn q/o"),
                 (256, 4096, "attn k/v"), (12288, 4096, "up/gate"),
                 (4096, 12288, "down"))
# xlstm-125m's: the mLSTM's q/k/v/o and the sLSTM's nine at 768 x 768, the
# mLSTM's gate projection w_if at N = 2 x heads = 8; whisper-tiny's three
# (the encoder's and the cross blocks' context K/V at M = 4 x 1,500
# frames); llama-3.2-vision's four
XLSTM_SHAPES = ((768, 768, "mLSTM q/k/v/o, sLSTM w_*/r_*/w_out"),
                (8, 768, "mLSTM w_if"))
WHISPER_SHAPES = ((384, 384, "attn and cross q/k/v/o"), (1536, 384, "MLP up"),
                  (384, 1536, "MLP down"))
VISION_SHAPES = ((8192, 8192, "attn and cross q/o"),
                 (1024, 8192, "attn and cross k/v"),
                 (28672, 8192, "MLP up/gate"), (8192, 28672, "MLP down"))
# moonshot-v1-16b-a3b's W4A8 linears (its experts are bf16, not B3's) and
# llama4-maverick-400b-a17b's (attention and the shared expert)
MOONSHOT_SHAPES = ((2048, 2048, "attn q/k/v/o"),)
LLAMA4_SHAPES = ((5120, 5120, "attn q/o"), (1024, 5120, "attn k/v"),
                 (8192, 5120, "shared expert up/gate"),
                 (5120, 8192, "shared expert down"))


def check_tgemm_arch(flush, arch="llama1-7b", shapes=LLAMA_SHAPES,
                      ms=(4, 512)):
    """B3 at an architecture's linear shapes: llama1-7b's three, (N, K) =
    (4096, 4096), (11008, 4096) and (4096, 11008), at M = 4 (decode) and
    512 (a bucketed prefill), or those given (recurrentgemma-9b's four at
    its phase 12 prefills' M too), w_bits 4, T=8: exact against the
    integer GEMM, one device op per call, with kernel ms (event-timed, L2
    flushed), the profiler's device us, ``torch._int_mm`` (M padded to 32)
    and the bound (``_tgemm_bound``). Returns {shape: numbers}."""
    import torch
    from repro_torch.core.backend import int_matmul
    from repro_torch.kernels.transitive_gemm import (k_split, lut_width,
                                                     transitive_gemm_cuda)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for n, k, role in shapes:
        w = torch.randint(-8, 8, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        for m in ms:
            x = torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=torch.int8)
            call = (lambda: transitive_gemm_cuda(x, w, w_bits=4))
            got = call()
            err = int((got[:, 0].long() - int_matmul(x, w.T).long())
                      .abs().max())
            width = lut_width(k, 1)[0]
            tag = (f"{arch} {role} N={n} K={k} M={m} w_bits=4 T=8 "
                   f"width={width} ksplit={k_split(m, n, k, 1, width, sms)}")
            if err:
                raise AssertionError(f"B3 at {tag}: max |diff| {err} from "
                                     f"the integer GEMM")
            k_ms = cuda_ms(call, flush)
            dev, ker, ops = device_us(call, kernels=("tgemm_lut",))
            if ops != 1:
                raise AssertionError(f"B3 at {tag} ran {ops} device ops "
                                     f"per call, not 1")
            xm = torch.zeros((max(-(-m // 8) * 8, 32), k),
                             dtype=torch.int8, device="cuda")
            xm[:m] = x
            wt = w.T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, wt), flush)
            lib_us, _, _ = device_us(lambda: torch._int_mm(xm, wt),
                                     kernels=())
            b_ms, b_by, _, _ = _tgemm_bound(m, n, k, 4, 1)
            print(f"[B3 {arch}] {tag}: exact | kernel_ms={k_ms:.4f} "
                  f"device us/call {dev:.2f} (kernel {ker:.2f}, one op) "
                  f"library_ms={lib_ms:.4f} (_int_mm, device us "
                  f"{lib_us:.2f}) bound_ms={b_ms:.6f} ({b_by})")
            out[f"N={n} K={k} M={m}"] = {
                "ms": k_ms, "device_us": dev, "kernel_us": ker,
                "library_ms": lib_ms, "library_us": lib_us, "bound_ms": b_ms,
                "bound_by": b_by}
    return out


def check_tgemm_generic(flush):
    """B3 at T outside {4, 8}. T only blocks K (the result is the same
    int32 for every T), so ``transitive_gemm_cuda`` runs every T through
    the one kernel, ``tgemm_lut``, at the width ``lut_width`` picks from K
    and groups: 8 where K / groups is a multiple of 8, else 4, in the
    unaligned instance where it is not a multiple of 4 (bytes staged by
    plain loads, each group's last subtile zero-filled). Exact against the
    integer GEMM and (T <= 16: its LUT has 2^T entries) the plain version
    at N=1536, M=4, K the largest multiple of T up to 576, T in {1, 2, 3,
    5, 6, 7, 9, 12, 16, 32} x w_bits in {2, 4, 8}, and one grouped case.
    Two more cases hold the two width-4 instances side by side at 145
    subtiles, one on each side of ``lut_width``'s choice: T=2 at K=580
    (aligned) and T=3 at K=579 (unaligned). Each call must be one launch
    (the wrapper's count) and one device kernel, the ``tgemm_lut``
    instance expected: T=5 at K=575, T=7 at K=574 and T=3 at K=579 the
    unaligned one, T=2 at K=580 aligned width 4, every other case width
    8. Times T=6 at K=576 (returns its JSON entry), T=5 at K=575, T=2 at
    K=580 and T=3 at K=579: kernel ms (event-timed, L2 flushed), the
    profiler's device us (the whole call and the kernel alone), plain ms,
    ``torch._int_mm`` (M padded to 32, K to a multiple of 8 with zeros)
    and the bound: x, w and the int32 output once over
    the memory rate, or the function's nibble-LUT adds at its K
    (``_tgemm_bound``) over the scalar rate."""
    import torch
    from repro_torch.core.backend import int_matmul
    from repro_torch.kernels.transitive_gemm import (lut_width,
                                                     transitive_gemm_cuda,
                                                     transitive_gemm_plain)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(1536, 576 // t * t, 4, bits, t, 1)
             for t in (1, 2, 3, 5, 6, 7, 9, 12, 16, 32)
             for bits in (2, 4, 8)]
    cases += [(576, 1536, 4, 4, 6, 4), (1536, 580, 4, 4, 2, 1),
              (1536, 579, 4, 4, 3, 1)]
    expected = {575: (4, False), 574: (4, False), 579: (4, False),
                580: (4, True)}
    worst, timed = 0, {}
    for n, k, m, w_bits, t, groups in cases:
        lim = 1 << (w_bits - 1)
        w = torch.randint(-lim, lim, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        kw = dict(w_bits=w_bits, t=t, groups=groups)
        width, aligned = lut_width(k, groups)
        expect = expected.get(k, (8, True))
        if (width, aligned) != expect:
            raise AssertionError(f"T={t} K={k} picked width {width}, "
                                 f"aligned {aligned}; expected {expect}")
        before = transitive_gemm_cuda.launches
        got = transitive_gemm_cuda(x, w, **kw)
        if transitive_gemm_cuda.launches != before + 1:
            raise AssertionError(f"T={t} was not one launch of tgemm_lut")
        kg = k // groups
        gemm = torch.stack([int_matmul(x[:, i * kg:(i + 1) * kg],
                                       w[:, i * kg:(i + 1) * kg].T)
                            for i in range(groups)], dim=1)
        want = transitive_gemm_plain(x, w, **kw) if t <= 16 else gemm
        torch.cuda.synchronize()
        err = max(int((got.long() - want.long()).abs().max()),
                  int((got.long() - gemm.long()).abs().max()))
        worst = max(worst, err)
        tag = (f"N={n} K={k} M={m} w_bits={w_bits} T={t} G={groups} "
               f"width={width}{'' if aligned else ' unaligned'}")
        if err:
            raise AssertionError(f"transitive_gemm != plain at {tag}: max "
                                 f"|diff| {err}")
        call = (lambda: transitive_gemm_cuda(x, w, **kw))
        names = kernel_names(call)
        instance = (f"tgemm_lut<{width}, 4, {w_bits}, "
                    f"{str(not aligned).lower()}>")
        if len(names) != 1 or instance not in names[0]:
            raise AssertionError(f"{tag} ran {names}, not one {instance}")
        if (t, k, w_bits, groups) not in ((6, 576, 4, 1), (5, 575, 4, 1),
                                          (2, 580, 4, 1), (3, 579, 4, 1)):
            continue
        k_ms = cuda_ms(call, flush)
        dev, ker, _ = device_us(call, kernels=("tgemm_lut",))
        p_ms = cuda_ms(lambda: transitive_gemm_plain(x, w, **kw), flush)
        xm = torch.zeros((32, -(-k // 8) * 8), dtype=torch.int8,
                         device="cuda")
        xm[:m, :k] = x
        wt = torch.zeros((n, xm.shape[1]), dtype=torch.int8, device="cuda")
        wt[:, :k] = w
        wt = wt.T
        lib_ms = cuda_ms(lambda: torch._int_mm(xm, wt), flush)
        lib_us, _, _ = device_us(lambda: torch._int_mm(xm, wt), kernels=())
        b_ms, b_by, _, _ = _tgemm_bound(m, n, k, w_bits, groups)
        print(f"[B3 generic] {tag}: exact, one tgemm_lut | kernel_ms="
              f"{k_ms:.4f} device us/call {dev:.2f} (kernel {ker:.2f}) "
              f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} (_int_mm, "
              f"device us {lib_us:.2f}) bound_ms={b_ms:.6f} ({b_by})")
        timed[k] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib_ms,
                    "device_us": dev, "kernel_us": ker}
    print(f"[B3 generic] {len(cases)} cases exact, each one tgemm_lut "
          f"launch (T 1, 2, 3, 5, 6, 7, 9, 12, 16, 32 x w_bits 2, 4, 8, one "
          f"grouped, T=2 at K=580 aligned width 4; T=5 at K=575, T=7 at "
          f"K=574 and T=3 at K=579 unaligned)")
    return dict(timed[576], shape="N=1536 K=576 M=4 w_bits=4 T=6 (width 8)",
                max_abs_err=worst,
                unaligned={"shape": "N=1536 K=575 M=4 w_bits=4 T=5 "
                                    "(width 4, unaligned)", **timed[575]},
                width4={"shape": "N=1536 K=580 M=4 w_bits=4 T=2 (width 4, "
                                 "aligned)", **timed[580]},
                width4_unaligned={"shape": "N=1536 K=579 M=4 w_bits=4 T=3 "
                                           "(width 4, unaligned)",
                                  **timed[579]})


def _wide_linear(w, t, groups=1, bits=4):
    """One engine_cuda linear at width T: (the plan the backend attaches,
    ForestPlan or SparseForestPlan; the DevicePlan of the same
    ExecutionPlan; seconds to plan, lower and pack)."""
    import torch
    from repro_torch.core.backend import get_backend
    from repro_torch.core.engine import BatchedTransitiveEngine, compile_plan
    t0 = time.perf_counter()
    plan = BatchedTransitiveEngine(bits, t).plan(w, groups=groups)
    fplan = get_backend("engine_cuda").compile(plan, device="cuda")
    dplan = compile_plan(plan, device="cuda")
    torch.cuda.synchronize()
    return fplan, dplan, time.perf_counter() - t0


def _wide_exact(tag, w, fplan, dplan, qx):
    """The row entry on ``qx`` (M, K) int8 and the (K, M) entry, each one
    launch of the plan's kernel (``forest_fused16`` for a ForestPlan,
    ``forest_sparse`` for a SparseForestPlan; launch count and profiler
    name), exact against ``run_device`` on the DevicePlan, the plan's plain
    version and the integer GEMM per group. Returns (the row entry's call,
    max |diff|)."""
    import torch
    from repro_torch.core.backend import int_matmul
    from repro_torch.core.engine import (SparseForestPlan, forest_plan_plain,
                                         run_device, sparse_forest_plain)
    from repro_torch.kernels.transitive_forest import (
        transitive_forest, transitive_forest_rows)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    if isinstance(fplan, SparseForestPlan):
        kernel, counter, plain = ("forest_sparse", launch_sparse,
                                  sparse_forest_plain)
    else:
        kernel, counter, plain = ("forest_fused16", transitive_forest_dense,
                                  forest_plan_plain)
    x = qx.T.to(torch.int32).contiguous()
    before = counter.launches
    got_rows = transitive_forest_rows(fplan, qx)
    got = transitive_forest(fplan, x)
    if counter.launches != before + 2:
        raise AssertionError(f"{tag}: not one {kernel} launch per call")
    g, k = fplan.groups, fplan.k
    kg = k // g
    gemm = torch.stack([int_matmul(w[:, i * kg:(i + 1) * kg],
                                   x[i * kg:(i + 1) * kg])
                        for i in range(g)], dim=1)               # (N, G, M)
    want = [run_device(dplan, x), plain(fplan, x),
            gemm[:, 0] if g == 1 else gemm]
    as_km = got_rows.T if g == 1 else got_rows.permute(2, 1, 0)
    torch.cuda.synchronize()
    err = max(int((a.long() - b.long()).abs().max())
              for a in (got, as_km) for b in want)
    if err:
        raise AssertionError(f"{tag}: {kernel} != plain, max |diff| {err}")
    call = (lambda: transitive_forest_rows(fplan, qx))
    for fn in (call, lambda: transitive_forest(fplan, x)):
        names = kernel_names(fn)
        if len(names) != 1 or kernel not in names[0]:
            raise AssertionError(f"{tag} ran {names}, not one {kernel}")
    return call, err


def check_forest_dense(flush):
    """B1 for plans with T > 8: from 9 <= T <= 15 ``engine_cuda`` attaches
    ForestPlans with int16 gathers, run by one launch of the fused kernel
    ``forest_fused16`` per call. Cases (each exact against the DevicePlan's
    ``run_device``, the ForestPlan's ``forest_plan_plain`` and the integer
    GEMM, through both entries, each call one ``forest_fused16`` by
    profiler name):

      * a T=9 ``engine_cuda`` linear (N=1536, K=576, W4, per-channel) at M
        in {4, 64}: its plan a ForestPlan with int16 rows (its bytes and
        the DevicePlan's printed), its ``linear_apply`` equal to
        ``engine_torch``'s;
      * T=12 at smollm-135m's four linear shapes at M=4, 1536x576 at
        M=512, and the grouped down-projection (576x1536) at M=4 in 16
        groups of 96: a group holds whole 12-wide tiles (128 does not);
      * extreme values at T=12 (96x576) and T=15 (40x60): every activation
        -128 or 127, every weight -8 or 7.

    Timed at M=4, T=9 and the four T=12 shapes (the row entry, as the
    serving path calls it): kernel ms (event-timed, L2 flushed), the
    profiler's device us (the kernel alone), ``torch._int_mm`` (M padded
    to 32), plain ms (``forest_plan_plain``), and the two-pass kernel
    (the route of T >= 16 plans too large for ``forest_sparse``) on the
    same DevicePlan, the same x, exact too.
    Three bounds, labelled: the function's (x and
    the int8 weights read once, the int32 output written once, over the
    memory rate, or this plan's adds over the scalar rate: the JSON
    entry's), and the same with the ForestPlan's bytes, what this design
    reads, or the DevicePlan's, what the two-pass kernel read, in place of
    the weights'. Returns the JSON entry (T=9, M=4)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import ForestPlan, forest_plan_plain
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.quant import QuantConfig, linear_apply
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    entry, timed, worst = None, {}, 0
    cases = [(9, 1536, 576, (4, 64), 1)]
    cases += [(12, n, k, (4,), 1) for n, k in SHAPES]
    cases += [(12, 1536, 576, (512,), 1), (12, 576, 1536, (4,), 16)]
    for t, n, k, ms, g in cases:
        w = rng.integers(-8, 8, size=(n, k))
        fplan, dplan, plan_s = _wide_linear(w, t, g)
        if not isinstance(fplan, ForestPlan) or \
                fplan.rows.dtype != torch.int16:
            raise AssertionError(f"T={t}: engine_cuda's plan is not a "
                                 f"ForestPlan with int16 rows")
        qw = torch.from_numpy(w).to("cuda", torch.int8)
        for m in ms:
            qx = torch.randint(-128, 128, (m, k), generator=gen,
                               device="cuda", dtype=torch.int8)
            tag = f"[B1 dense] N={n} K={k} M={m} T={t} G={g}"
            call, err = _wide_exact(tag, qw, fplan, dplan, qx)
            worst = max(worst, err)
            print(f"{tag} (planned + lowered + packed in {plan_s:.2f}s; "
                  f"ForestPlan {fplan.nbytes()} B, DevicePlan "
                  f"{dplan.nbytes()} B): exact, one forest_fused16 per call")
            if m != 4 or g != 1:
                continue
            k_ms = cuda_ms(call, flush)
            dev, ker, ops = device_us(call, kernels=("forest_fused16",))
            xm = torch.zeros((32, k), dtype=torch.int8, device="cuda")
            xm[:m] = qx
            wt = qw.T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, wt), flush)
            x_bytes, out_bytes = m * k, n * m * 4
            f_ms, f_by = _forest_bound(fplan, m, x_bytes)
            b_ms, b_by = bound_ms(n * k + x_bytes + out_bytes,
                                  _forest_ops(fplan, m), SCALAR_OPS_PER_S)
            d_ms, d_by = bound_ms(dplan.nbytes() + x_bytes + out_bytes,
                                  _forest_ops(fplan, m), SCALAR_OPS_PER_S)
            x = qx.T.to(torch.int32).contiguous()
            p_ms = cuda_ms(lambda: forest_plan_plain(fplan, x), flush,
                           iters=5, warmup=1)
            # the two-pass kernel (T >= 16 plans too large for
            # forest_sparse) on the DevicePlan
            two = (lambda: transitive_forest_dense(dplan, x))
            if not torch.equal(two(), forest_plan_plain(fplan, x)):
                raise AssertionError(f"{tag}: two-pass kernel != plain")
            two_ms = cuda_ms(two, flush)
            two_us, _, _ = device_us(two, kernels=("forest_dense",))
            print(f"{tag}: kernel_ms={k_ms:.4f} device us/call {dev:.2f} "
                  f"(kernel {ker:.2f}, {ops:.0f} ops) plain_ms={p_ms:.4f} "
                  f"library_ms={lib_ms:.4f} (_int_mm, M padded to 32) "
                  f"bound_ms={b_ms:.6f} ({b_by}; function: x, int8 "
                  f"weights, output) | ForestPlan's bytes for the weights' "
                  f"{f_ms:.6f} ({f_by}) | DevicePlan's {d_ms:.6f} ({d_by}) "
                  f"| two-pass kernel on the DevicePlan, (K, M) entry: "
                  f"kernel_ms={two_ms:.4f} device us/call {two_us:.2f}")
            timed[(t, n, k)] = {"ms": k_ms, "device_us": dev,
                                "kernel_us": ker, "plain_ms": p_ms,
                                "library_ms": lib_ms,
                                "bound_ms": b_ms, "bound_by": b_by,
                                "forestplan_bound_ms": f_ms,
                                "deviceplan_bound_ms": d_ms,
                                "forestplan_bytes": fplan.nbytes(),
                                "deviceplan_bytes": dplan.nbytes(),
                                "two_pass_ms": two_ms,
                                "two_pass_device_us": two_us}
            if t == 9:
                entry = dict(timed[(t, n, k)],
                             shape="N=1536 K=576 M=4 T=9 (engine_cuda "
                                   "linear, row entry)")
        if (t, n, k, g) == (12, 1536, 576, 1) and \
                fplan.nbytes() > 800_000:
            raise AssertionError(f"T=12 ForestPlan {fplan.nbytes()} B > "
                                 f"0.8 MB")
        if t == 9:
            # the whole linear: engine_cuda (fused kernel) == engine_torch
            sg = torch.rand((n, 1), generator=gen, device="cuda") * 0.01 \
                + 1e-3
            x = torch.randn((4, k), generator=gen, device="cuda")
            outs = []
            for name, plan in (("engine_cuda", fplan),
                               ("engine_torch", dplan)):
                cfg = QuantConfig(mode="ptq", w_bits=4, group=0,
                                  backend=name, transrow_t=t)
                outs.append(linear_apply({"qw": qw, "sg": sg,
                                          "dplan": plan}, x, cfg))
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError("T=9 linear_apply: engine_cuda != "
                                     "engine_torch")
            print("[B1 dense] T=9 linear_apply on engine_cuda == "
                  "engine_torch")
    # extreme values: every activation -128 or 127, every weight -8 or 7
    for t, n, k in ((12, 96, 576), (15, 40, 60)):
        for xv, wv in ((-128, -8), (127, 7), (-128, 7), (127, -8)):
            w = np.full((n, k), wv)
            fplan, dplan, _ = _wide_linear(w, t)
            qx = torch.full((4, k), xv, dtype=torch.int8, device="cuda")
            _, err = _wide_exact(f"[B1 dense] extreme T={t} x={xv} w={wv}",
                                 torch.from_numpy(w).to("cuda", torch.int8),
                                 fplan, dplan, qx)
            worst = max(worst, err)
    print("[B1 dense] extreme values at T=12 (96x576) and T=15 (40x60), x "
          "in {-128, 127} x w in {-8, 7}: exact, one forest_fused16 each")
    entry["max_abs_err"] = worst
    entry["t12"] = {f"N={n} K={k}": timed[(12, n, k)] for n, k in SHAPES}
    return entry


def _sparse_ops(splan, m):
    """This sparse plan's adds: one per chained slot, popcount per direct
    slot, one per APE gather, per column."""
    import numpy as np
    from repro_torch.core.engine import SPARSE_DIRECT
    codes = splan.codes.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    slot = np.arange(splan.slots)
    live = (slot >= 1) & (slot < splan.bounds.cpu().numpy()[..., -1:])
    direct = (codes & SPARSE_DIRECT) != 0
    pops = sum(bin(int(v)).count("1")
               for v in codes[live & direct] & (SPARSE_DIRECT - 1))
    return (int((live & ~direct).sum()) + pops + splan.rows.numel()) * m


def check_forest_sparse(flush):
    """B1 for plans with T >= 16 (B1s): ``engine_cuda`` packs them into
    SparseForestPlans (each tile's made nodes only, renumbered in level
    order: int16 slots), run by one launch of ``forest_sparse`` per call.
    Cases, each exact against the DevicePlan's ``run_device``,
    ``sparse_forest_plain`` and the integer GEMM, through both entries,
    each call one ``forest_sparse`` by launch count and profiler name:

      * the timed case, one ``engine_cuda`` T=16 linear at N=1536, K=64
        (J=4 tiles; K cut from smollm-135m's 576 because planning at T=16
        takes ~25 s per 1536 x 64 on the host), W4, ungrouped, at M=4 and
        M=64;
      * T=16 in 2 groups (96x128), 8-bit weights (64x32), T=17 in 2 groups
        (64x68, M=9), and extreme values at T=16 (40x64): every activation
        -128 or 127, every weight -8 or 7.

    Per timed call (the row entry, as the serving path calls it): kernel
    ms (event-timed, L2 flushed), the profiler's device us (the kernel
    alone), ``torch._int_mm`` (M padded to 32), plain ms
    (``sparse_forest_plain``), the function's bound (x, the int8 weights
    and the int32 output over the memory rate, or this plan's adds over
    the scalar rate: the JSON entry's) and the same with the
    SparseForestPlan's bytes or the DevicePlan's in place of the weights';
    and the parent's design, the two-pass kernel, on the same DevicePlan
    and the same x: exact too, with its kernel ms and device us. The plans'
    bytes are printed, and the compact plan must be at least 50x smaller.
    Returns the JSON entry (M=4)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (SparseForestPlan, run_device,
                                         sparse_forest_plain)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    rng = np.random.default_rng(16)
    gen = torch.Generator(device="cuda").manual_seed(16)
    timed, worst = {}, 0
    # (T, N, K, M's, groups, weight bits, fill: (x, w) everywhere or None)
    cases = [(16, 1536, 64, (4, 64), 1, 4, None),
             (16, 96, 128, (4,), 2, 4, None), (16, 64, 32, (4,), 1, 8, None),
             (17, 64, 68, (9,), 2, 4, None)]
    cases += [(16, 40, 64, (4,), 1, 4, f) for f in
              ((-128, -8), (127, 7), (-128, 7), (127, -8))]
    for t, n, k, ms, g, bits, fill in cases:
        lo = 1 << (bits - 1)
        w = (rng.integers(-lo, lo, size=(n, k)) if fill is None
             else np.full((n, k), fill[1]))
        splan, dplan, plan_s = _wide_linear(w, t, g, bits)
        if not isinstance(splan, SparseForestPlan):
            raise AssertionError(f"T={t}: engine_cuda's plan is not a "
                                 f"SparseForestPlan")
        ratio = dplan.nbytes() / splan.nbytes()
        qw = torch.from_numpy(w).to("cuda", torch.int8)
        for m in ms:
            qx = (torch.randint(-128, 128, (m, k), generator=gen,
                                device="cuda", dtype=torch.int8)
                  if fill is None else torch.full((m, k), fill[0],
                                                  dtype=torch.int8,
                                                  device="cuda"))
            tag = (f"[B1 sparse] N={n} K={k} M={m} T={t} G={g} W{bits}"
                   + (f" x={fill[0]} w={fill[1]}" if fill else ""))
            call, err = _wide_exact(tag, qw, splan, dplan, qx)
            worst = max(worst, err)
            print(f"{tag} (planned + lowered + packed in {plan_s:.2f}s; "
                  f"U={splan.slots} slots a tile; SparseForestPlan "
                  f"{splan.nbytes()} B, DevicePlan {dplan.nbytes()} B, "
                  f"{ratio:.1f}x): exact, one forest_sparse per call")
            if (n, k) != (1536, 64):
                continue
            if ratio < 50:
                raise AssertionError(f"{tag}: SparseForestPlan only "
                                     f"{ratio:.1f}x below the DevicePlan")
            k_ms = cuda_ms(call, flush)
            dev, ker, ops = device_us(call, kernels=("forest_sparse",))
            xm = torch.zeros((max(32, m), k), dtype=torch.int8,
                             device="cuda")
            xm[:m] = qx
            wt = qw.T
            lib_ms = cuda_ms(lambda: torch._int_mm(xm, wt), flush)
            lib_us, _, _ = device_us(lambda: torch._int_mm(xm, wt),
                                     kernels=())
            x_bytes, out_bytes = m * k, n * m * 4
            adds = _sparse_ops(splan, m)
            b_ms, b_by = bound_ms(n * k + x_bytes + out_bytes, adds,
                                  SCALAR_OPS_PER_S)
            s_ms, s_by = bound_ms(splan.nbytes() + x_bytes + out_bytes,
                                  adds, SCALAR_OPS_PER_S)
            d_ms, d_by = bound_ms(dplan.nbytes() + x_bytes + out_bytes,
                                  adds, SCALAR_OPS_PER_S)
            x = qx.T.to(torch.int32).contiguous()
            p_ms = cuda_ms(lambda: sparse_forest_plain(splan, x), flush,
                           iters=5, warmup=1)
            # the parent's design: the two-pass kernel on the DevicePlan
            two = (lambda: transitive_forest_dense(dplan, x))
            if not torch.equal(two(), run_device(dplan, x)):
                raise AssertionError(f"{tag}: two-pass kernel != plain")
            two_ms = cuda_ms(two, flush, iters=3, warmup=1)
            two_us, _, _ = device_us(two, kernels=("forest_dense",),
                                     iters=3)
            print(f"{tag}: kernel_ms={k_ms:.4f} device us/call {dev:.2f} "
                  f"(kernel {ker:.2f}, {ops:.0f} ops) plain_ms={p_ms:.4f} "
                  f"library_ms={lib_ms:.4f} (_int_mm, M padded to >= 32; "
                  f"device us {lib_us:.2f}) bound_ms={b_ms:.6f} ({b_by}; "
                  f"function: x, int8 weights, output) | SparseForestPlan's "
                  f"bytes for the weights' {s_ms:.6f} ({s_by}) | "
                  f"DevicePlan's {d_ms:.6f} ({d_by}) | two-pass kernel on "
                  f"the DevicePlan, (K, M) entry: kernel_ms={two_ms:.4f} "
                  f"device us/call {two_us:.2f} ({two_us / ker:.1f}x "
                  f"forest_sparse's)")
            timed[m] = {"ms": k_ms, "device_us": dev, "kernel_us": ker,
                        "plain_ms": p_ms, "library_ms": lib_ms,
                        "library_device_us": lib_us, "bound_ms": b_ms,
                        "bound_by": b_by, "sparseplan_bound_ms": s_ms,
                        "deviceplan_bound_ms": d_ms,
                        "sparseplan_bytes": splan.nbytes(),
                        "deviceplan_bytes": dplan.nbytes(),
                        "two_pass_ms": two_ms,
                        "two_pass_device_us": two_us}
    print("[B1 sparse] T=16 grouped, 8-bit, T=17 and extreme values: exact, "
          "one forest_sparse each")
    return dict(timed[4], shape="N=1536 K=64 M=4 T=16 (engine_cuda linear, "
                                "row entry; K cut from 576)",
                max_abs_err=worst, m64=timed[64])


def _w4a8_exact(x, sx, w, sg, group, ranges):
    """The function in float64 on the card (exact: integer group dots, each
    group term exact) and, for each instance, the first-order bound of its
    order of f32 roundings, u = 2^-24, times 1.01 for second-order terms.
    ``w4a8_wgmma`` (each rank adds its groups' terms in increasing g,
    ``ranges``, the ranks' sums are added in rank order, then times sx): u
    (sum over the products of |term|, over each rank's additions of
    |partial sum|, over the rank sums of |running total|) |sx| + u |out|.
    ``w4a8_dot`` (warp v adds the terms of groups v, v + 8, ... in
    increasing g, then the eight warp sums in order, then times sx): u
    (sum over the additions of |partial sum| + |term|, plus the partial
    sums of the warp sums) |sx| + u |out|, as
    tests/test_torch_kernels.py::_w4a8_bound."""
    import torch
    m, k = x.shape
    n, groups = w.shape[0], k // group
    terms = torch.einsum("mgi,ngi->mgn",
                         x.reshape(m, groups, group).to(torch.float64),
                         w.reshape(n, groups, group).to(torch.float64))
    terms *= sg.to(torch.float64).T[None]
    s = sx.to(torch.float64).reshape(m, 1)
    exact = terms.sum(1) * s
    errs = {}
    for kernel, chains in (("w4a8_wgmma", [slice(lo, hi)
                                           for lo, hi in ranges]),
                           ("w4a8_dot", [slice(v, None, 8)
                                         for v in range(8)])):
        err = terms.abs().sum(1)
        totals = []
        for chain in chains:
            run = terms[:, chain].cumsum(1)
            err += run[:, 0 if kernel == "w4a8_dot" else 1:].abs().sum(1)
            totals.append(terms[:, chain].sum(1))     # 0 for an idle warp
            del run
        err += torch.stack(totals).cumsum(0)[1:].abs().sum(0)
        errs[kernel] = 1.01 * 2.0 ** -24 * (err * s.abs() + exact.abs())
        del err, totals
    del terms
    return exact, errs


def check_w4a8(flush):
    """B4 vs its plain versions; returns the JSON entry (the serving shape
    N=1536, K=576, group 64, M=4, with every shape's numbers under
    ``shapes``).

    The tensor-core instance ``w4a8_wgmma`` (groups 32 to 256 on aligned
    bases) at smollm-135m's (N, K, group) = (1536, 576, 64), (576, 1536,
    128) and llama1_7b's (11008, 4096, 128), (4096, 11008, 128), each at M
    = 4 and 512: bit-equal to ``w4a8_gemm_ordered`` (its own order, plain
    torch) and within the first-order bound of that order from the
    function in float64; timed beside ``w4a8_dot`` (any group, any K) on
    the same data in turns (the profiler's device us of the kernel alone
    and event-timed ms, the L2 flushed before each call), with
    ``torch._int_mm``'s device time for the ungrouped int8 product (M
    padded to 32: not the same function, for scale). ``w4a8_dot`` is held
    at those eight shapes to the first-order bound of its own order from
    the same float64 function. ``w4a8_dot`` alone at group 6 (byte-wise
    dots) and K=32,768 (eight activation tiles) at M=4, the parent's own
    checks.

    Tolerance against the plain version (the reference's order): the
    reference's, rtol 2e-3 and atol 1e-2 (tests/test_kernels.py), for
    both instances, held at every shape but llama1_7b's at M = 512. There
    each output sums 32 or 86 group terms of up to ~10^4 with partial
    sums near 10^5, so two f32 orders part by more than atol 1e-2 where
    an output cancels to near zero: the plain version itself, against the
    function in float64, does so too. The outputs beyond it are counted
    and printed there, for all three; both instances are held there to
    their first-order bounds instead."""
    import torch
    from repro_torch.kernels import w4a8_gemm as w4
    lib = w4._library()
    gen = torch.Generator(device="cuda").manual_seed(4)
    entry, worst, shapes = None, 0.0, []
    cases = [(n, k, g, m) for n, k, g in ((1536, 576, 64), (576, 1536, 128),
                                          (11008, 4096, 128),
                                          (4096, 11008, 128))
             for m in (4, 512)]
    cases += [(1536, 576, 6, 4), (576, 32768, 128, 4)]
    for n, k, g, m in cases:
        x = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-8, 8, (n, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        sx = torch.rand((m, 1), generator=gen, device="cuda") * 1.5 + 0.5
        sg = torch.rand((n, k // g), generator=gen,
                        device="cuda") * 1.5 + 0.5
        sxc = sx.reshape(m).contiguous()
        tag = f"N={n} K={k} group={g} M={m}"
        dot_only = g == 6 or k == 32768
        picked = w4.launch_plan(m, n, k, g, x.data_ptr(), w.data_ptr())
        plans = {"w4a8_dot": w4.dot_plan(m, n, k, g)}
        if not dot_only:
            if picked.kernel != "w4a8_wgmma":
                raise AssertionError(f"launch_plan at {tag}: {picked.kernel}")
            plans["w4a8_wgmma"] = picked
        shown = picked if not dot_only else plans["w4a8_dot"]
        want = w4.w4a8_gemm_plain(x, sx, w, sg, group=g)
        held = not (n in (11008, 4096) and m == 512)
        outs, row = {}, {"shape": tag}
        for name, plan in plans.items():
            out = torch.empty((m, n), device="cuda")
            w4._launch(lib, x, sxc, w, sg, out, g, plan)
            torch.cuda.synchronize()
            outs[name] = out
            err = float((out - want).abs().max())
            worst = max(worst, err)
            beyond = int((~torch.isclose(out, want, rtol=2e-3,
                                         atol=1e-2)).sum())
            row[name] = {"max_abs_err": err, "beyond_tolerance": beyond}
            if held and beyond:
                raise AssertionError(f"{name} vs plain at {tag}: {beyond} "
                                     f"outputs beyond rtol 2e-3, atol 1e-2 "
                                     f"(max |diff| {err})")
        if not dot_only:
            got = outs["w4a8_wgmma"]
            ordered = w4.w4a8_gemm_ordered(x, sx, w, sg, group=g,
                                           plan=picked)
            if not torch.equal(got, ordered):
                raise AssertionError(f"w4a8_wgmma at {tag}: not bit-equal to "
                                     f"w4a8_gemm_ordered")
            del ordered
            exact, bounds = _w4a8_exact(x, sx, w, sg, g, picked.ranges)
            for name, bound in bounds.items():
                diff = (outs[name].to(torch.float64) - exact).abs()
                if not bool((diff <= bound).all()):
                    raise AssertionError(
                        f"{name} at {tag}: beyond its first-order bound, "
                        f"worst {float((diff / bound).max()):.3f}")
                del diff
            row["plain_beyond_tolerance_of_exact"] = int(
                (~torch.isclose(want, exact.to(torch.float32), rtol=2e-3,
                                atol=1e-2)).sum())
            del exact, bounds
        print(f"[B4] {tag}: plan {shown.kernel} bt={shown.bt} "
              f"split={shown.split} ns={shown.ns} kb={shown.kb} | "
              + "; ".join(f"{nm} max_abs_err vs plain "
                          f"{row[nm]['max_abs_err']:.3e}, beyond rtol 2e-3/"
                          f"atol 1e-2: {row[nm]['beyond_tolerance']}"
                          for nm in plans)
              + ("" if dot_only else
                 f" | w4a8_wgmma bit-equal to w4a8_gemm_ordered; both "
                 f"instances within their first-order bounds of float64; "
                 f"plain beyond the tolerance of float64: "
                 f"{row['plain_beyond_tolerance_of_exact']}")
              + ("" if held else " (tolerance reported, not held: see "
                 "check_w4a8)"))
        times = {}
        for name in (["w4a8_wgmma", "w4a8_dot", "w4a8_dot", "w4a8_wgmma"]
                     if not dot_only else ["w4a8_dot"]):
            plan = plans[name]

            def call():
                w4._launch(lib, x, sxc, w, sg, outs[name], g, plan)

            def cold():                  # the flush's memset is left out
                flush.zero_()
                call()
            _, ker, _ = device_us(cold, kernels=("w4a8_wgmma", "w4a8_dot"))
            times.setdefault(name, []).append(
                (ker, cuda_ms(call, flush)))
        n_bytes = m * k + n * k + m * 4 + sg.numel() * 4 + m * n * 4
        b_ms, b_by = bound_ms(n_bytes, 2 * m * n * k, INT8_OPS_PER_S)
        row.update(bound_ms=b_ms, bound_by=b_by,
                   device_us={nm: [t[0] for t in v]
                              for nm, v in times.items()},
                   kernel_ms={nm: [t[1] for t in v]
                              for nm, v in times.items()})
        if not dot_only:
            xp = x if m >= 32 else torch.cat([x, x.new_zeros((32 - m, k))])
            wt = w.t()
            lib_us, _, _ = device_us(lambda: torch._int_mm(xp, wt),
                                     kernels=("",))
            row["int_mm_device_us"] = lib_us
            print(f"[B4] {tag}: torch._int_mm {lib_us:.2f} us (ungrouped, M "
                  f"padded to 32: not the same function, for scale)")
        print(f"[B4] {tag}: " + " | ".join(
            f"{nm} device us " + ", ".join(f"{t[0]:.2f}" for t in v)
            + " (kernel ms " + ", ".join(f"{t[1]:.4f}" for t in v) + ")"
            for nm, v in times.items())
            + f" | bound_ms={b_ms:.6f} ({b_by})")
        shapes.append(row)
        if (n, k, g, m) == (1536, 576, 64, 4):
            k_ms = cuda_ms(lambda: w4.w4a8_gemm_cuda(x, sx, w, sg, group=g),
                           flush)
            p_ms = cuda_ms(lambda: w4.w4a8_gemm_plain(x, sx, w, sg, group=g),
                           flush)
            dev, _, _ = device_us(
                lambda: w4.w4a8_gemm_cuda(x, sx, w, sg, group=g),
                kernels=("w4a8_wgmma", "w4a8_dot"))
            print(f"[B4] {tag}: w4a8_gemm_cuda kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} library_ms=null bound_ms="
                  f"{b_ms:.6f} ({b_by}) | device us/call {dev:.2f}")
            entry = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "device_us": dev,
                     "kernel": picked.kernel,
                     "shape": "N=1536 K=576 group=64 M=4"}
        del x, w, sg, sx, sxc, want, outs
        torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    entry["shapes"] = shapes
    return entry


def check_rg_lru(flush):
    """B5 vs its plain version; returns the JSON entry (float32 at B=4,
    with every pair's and the long shape's numbers under ``shapes``).

    recurrentgemma-9b's width D=4096 at B=4, S=2048 in (x, a) = (float32,
    float32), (bfloat16, bfloat16), (float16, float16) and (float32,
    bfloat16), and at B=1, S=65,536 in float32 (``long_500k``'s B=1 with
    S cut from 524,288: the plain version's S-step loop, which the check
    needs, must fit this script's time; it is not timed there). Kernel
    and plain version round the same operations in the same order: every
    case is held bit-equal, and each call must be one launch of the
    instance ``launch_plan`` picks, by the profiler's name."""
    import torch
    from repro_torch.kernels.rg_lru import (launch_plan, rg_lru_cuda,
                                            rg_lru_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    entry, worst, shapes = None, 0.0, []
    for b, s, xdt, adt in ((4, 2048, f32, f32), (4, 2048, bf16, bf16),
                           (4, 2048, f16, f16), (4, 2048, f32, bf16),
                           (1, 65536, f32, f32)):
        d = 4096
        x = torch.randn((b, s, d), generator=gen, device="cuda").to(xdt)
        a = (torch.rand((b, s, d), generator=gen, device="cuda") * 0.199
             + 0.8).to(adt)
        h0 = torch.randn((b, d), generator=gen, device="cuda").to(xdt)
        got = rg_lru_cuda(x, a, h0)
        want = rg_lru_plain(x, a, h0)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        worst = max(worst, err)
        if got.dtype != xdt or not torch.equal(got, want):
            raise AssertionError(f"rg_lru kernel vs plain, B={b} S={s} x "
                                 f"{xdt} a {adt}: not bit-equal, max |diff|"
                                 f" {err}")
        del want
        plan = launch_plan(b, s, d, x.element_size(), a.element_size(),
                           got.element_size(), x.data_ptr(), a.data_ptr(),
                           got.data_ptr())
        del got
        names = kernel_names(lambda: rg_lru_cuda(x, a, h0))
        dev, ker, ops = device_us(lambda: rg_lru_cuda(x, a, h0),
                                  kernels=(plan.kernel,))
        expect = 1 if h0.dtype == f32 else 2         # + h0's cast to f32
        if (sum(plan.kernel in n for n in names) != 1 or len(names) != expect
                or ops != expect):
            raise AssertionError(f"rg_lru: one {plan.kernel} launch per call"
                                 f" expected, the profiler saw {names} "
                                 f"({ops} device ops per call)")
        k_ms = cuda_ms(lambda: rg_lru_cuda(x, a, h0), flush)
        p_ms = None
        if s <= 2048:
            p_ms = cuda_ms(lambda: rg_lru_plain(x, a, h0), flush, iters=5,
                           warmup=1)
        n_bytes = b * s * d * (2 * x.element_size() + a.element_size()) \
            + b * d * h0.element_size()
        b_ms, b_by = bound_ms(n_bytes, 2 * b * s * d, SCALAR_OPS_PER_S)
        shape = f"B={b} S={s} D={d} x {str(xdt)[6:]} a {str(adt)[6:]}"
        print(f"[B5] {shape}: bit-equal | {plan.kernel} dt={plan.dt} "
              f"st={plan.st} ns={plan.ns} | kernel_ms={k_ms:.4f} plain_ms="
              + (f"{p_ms:.4f}" if p_ms is not None else "not timed")
              + f" library_ms=null bound_ms={b_ms:.6f} ({b_by}) | device "
              f"us/call {dev:.2f} (kernel {ker:.2f}, {ops:g} ops)")
        shapes.append({"shape": shape, "kernel": plan.kernel, "ms": k_ms,
                       "plain_ms": p_ms, "device_us": dev,
                       "kernel_us": ker, "bound_ms": b_ms})
        if entry is None:
            entry = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, "device_us": dev,
                     "shape": shape}
        del x, a, h0
        torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    entry["shapes"] = shapes
    return entry


def _prompts(vocab, n, length):
    """Even requests repeat a base prompt, odd ones share its first half
    (the launcher's workload, seed 1)."""
    from repro_torch.launch.serve import prefix_sharing_prompts
    return prefix_sharing_prompts(vocab, n, length, seed=1)


def _serve(model, params, prompts, gen, trace=None, **kw):
    """Serve ``prompts`` for ``gen`` tokens each; returns (engine, seconds).
    With a ``trace`` list, each decode step appends ([(slot, request id,
    index of the token made)], that step's last-position logits as host
    f32 (B, V))."""
    import torch
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(model, params, device=model.device, **kw)
    for p in prompts:
        eng.submit(p, gen)
    if trace is not None:
        decode, step = eng._decode, model.decode_step_paged

        def traced_decode(cell, packed):
            trace.append([[(s, r.rid, len(r.out)) for s, r in packed]])
            decode(cell, packed)

        def traced_step(*a, **k):
            logits, pool = step(*a, **k)
            trace[-1].append(logits[:, -1].float().cpu())
            return logits, pool
        eng._decode, model.decode_step_paged = traced_decode, traced_step
    t0 = time.perf_counter()
    try:
        eng.run()
        torch.cuda.synchronize()
    finally:
        if trace is not None:
            del model.decode_step_paged
    return eng, time.perf_counter() - t0


def _serve_shadowed(model, params, prompts, gen, **kw):
    """The kernel path once more, with B2's plain version computed beside
    every kernel call on the same inputs (the serving path's own q, pool,
    table and steps, on the card) and held to it by ``agreement``. The
    wrapper takes the module's ``paged_attention`` name for the run, so
    the kernel's launches here add to the wrapper's count, not to the
    kernel's. Returns (tokens by request, one agreement dict per call)."""
    import repro_torch.kernels.paged_attention as PA
    kernel, stats = PA.paged_attention, []

    def shadow(q, pool, page_indices, steps, cfg, scale):
        out = kernel(q, pool, page_indices, steps, cfg, scale)
        want = PA.paged_attention_plain(q, pool, page_indices, steps, cfg,
                                        scale)
        stats.append(PA.agreement(out, want, pool, page_indices, steps,
                                  cfg, q=q, scale=scale))
        return out
    shadow.launches = 0
    PA.paged_attention = shadow
    try:
        eng, _ = _serve(model, params, prompts, gen, paged_kernel=True,
                        **kw)
    finally:
        PA.paged_attention = kernel
    return {r.rid: r.tokens for r in eng.finished}, stats


def _partings(trace_k, trace_g):
    """Teacher-forced comparison of two runs of the same requests (kernel
    path, gather path) from their decode traces. Until a request's first
    differing token both runs feed it the same tokens, so its logits
    differ only by the two paths' arithmetic. Returns (the max |logit
    difference| of each agreeing (step, request) row, [(request, token
    index, gather path's top-2 margin, kernel path's, max |logit diff| of
    the row)] at each request's first parting, the gather path's top-2
    margins over the agreeing rows)."""
    import torch
    parted, diffs, partings, margins = set(), [], [], []
    for (rows_k, lk), (rows_g, lg) in zip(trace_k, trace_g):
        if rows_k != rows_g:
            break                     # the schedules part: stop comparing
        for s, rid, idx in rows_k:
            if rid in parted:
                continue
            top_k, top_g = lk[s].topk(2), lg[s].topk(2)
            gap_g = float(top_g.values[0] - top_g.values[1])
            gap_k = float(top_k.values[0] - top_k.values[1])
            d = float((lk[s] - lg[s]).abs().max())
            if int(top_k.indices[0]) != int(top_g.indices[0]):
                parted.add(rid)
                partings.append((rid, idx, gap_g, gap_k, d))
            else:
                diffs.append(d)
                margins.append(gap_g)
    nan = [float("nan")]
    return (torch.tensor(diffs or nan), partings,
            torch.tensor(margins or nan))


def check_reduced_serve():
    """The forest kernel inside the serve path is exact: a reduced f32
    smollm served with engine_cuda and with engine_torch (plain forest),
    both on the gather decode, gives the same tokens."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    toks = {}
    for backend in ("engine_cuda", "engine_torch"):
        cfg = serve_config(get_reduced("smollm_135m"),
                           backend=backend).replace(dtype=torch.float32)
        model = Model(cfg, device="cuda")
        params = model.attach_device_plans(model.init(0))
        eng, _ = _serve(model, params, _prompts(cfg.vocab, 6, 12), 6,
                        n_slots=3, max_len=32, page_size=4)
        toks[backend] = {r.rid: r.tokens for r in eng.finished}
    if toks["engine_cuda"] != toks["engine_torch"]:
        raise AssertionError(f"reduced serve: forest kernel tokens "
                             f"{toks['engine_cuda']} != plain "
                             f"{toks['engine_torch']}")
    print(f"[serve reduced f32] engine_cuda tokens == engine_torch tokens "
          f"({sum(map(len, toks['engine_cuda'].values()))} tokens)")


def main_path():
    """Full-width smollm-135m through ServeEngine with both kernels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ForestPlan, pack_forest_plan
    from repro_torch.core.plancache import _iter_ptq_layers
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    cfg = serve_config(get_config("smollm_135m"),
                       backend="engine_cuda").replace(paged_kernel=True)
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    raw = model.init(0)
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = model.precompile_plans(raw)
    params = model.attach_device_plans(raw)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    layers = list(_iter_ptq_layers(params))
    if not all(isinstance(layer.get("dplan"), ForestPlan)
               for layer in layers):
        raise AssertionError("engine_cuda params must carry ForestPlans")
    plan_bytes = sum(layer["dplan"].nbytes() for layer in layers)
    weight_bytes = sum(layer["qw"].numel() * layer["qw"].element_size()
                       for layer in layers)
    print(f"[main] {cfg.name}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} | init {t_init:.2f}s | "
          f"planned {stats['plans']} linears in {t_plan:.2f}s "
          f"(plan + lower + pack + upload) | compact ForestPlans on the "
          f"card {plan_bytes} B = {plan_bytes / weight_bytes:.3f} x the "
          f"int8 weights ({weight_bytes} B)")
    if stats["plans"] != 7 * cfg.n_layers:
        raise AssertionError(f"expected {7 * cfg.n_layers} plans, got "
                             f"{stats['plans']}")
    counted = _gates().take("phase 5 (precompile + attach)")
    pub = _gate(counted, "cache-publish")
    print(f"[main] plan verifier: {pub['artifacts']} plans verified at "
          f"cache-publish ({stats['built']} cache misses), "
          f"{pub['findings']} findings, {pub['s']:.2f}s of the "
          f"{t_plan:.2f}s planning")
    if (pub["artifacts"], pub["findings"]) != (stats["built"], 0) or \
            stats["built"] != 7 * cfg.n_layers or set(counted) != {
                "cache-publish"}:
        raise AssertionError(f"phase 5: the publish gate verified "
                             f"{counted}, {stats['built']} plans built")
    if plan_bytes >= weight_bytes:
        raise AssertionError(f"plans ({plan_bytes} B) not below the int8 "
                             f"weights ({weight_bytes} B)")
    prompts = _prompts(cfg.vocab, 8, 128)
    kw = dict(n_slots=4, max_len=256, page_size=16)
    transitive_forest.launches = 0
    paged_attention.launches = 0
    packs = pack_forest_plan.calls
    eng, dt = _serve(model, params, prompts, 32, paged_kernel=True, **kw)
    launches = {"transitive_forest": transitive_forest.launches,
                "paged_attention": paged_attention.launches}
    packs = pack_forest_plan.calls - packs
    rep = eng.report()
    c = rep["counters"]
    ttft = sum(r["ttft_s"] for r in rep["requests"]) / len(rep["requests"])
    toks = {r.rid: r.tokens for r in eng.finished}
    if sorted(len(t) for t in toks.values()) != [32] * 8 or not all(
            0 <= t < cfg.vocab for ts in toks.values() for t in ts):
        raise AssertionError(f"main path output malformed: {toks}")
    print(f"[main] 8 requests x 32 tokens in {dt:.3f}s -> "
          f"{rep['total_tokens'] / dt:.1f} tokens/s | mean TTFT "
          f"{ttft * 1e3:.1f} ms | decode steps {c['decode_steps']} | "
          f"prefix hits={c['prefix_hits']} pages_shared="
          f"{c['pages_shared']} prefill_skipped={c['prefill_skipped']} "
          f"prefill_computed={c['prefill_computed']} batched_prefills="
          f"{c['prefill_batched_calls']}")
    print(f"[main] launches: transitive_forest={launches['transitive_forest']}"
          f" paged_attention={launches['paged_attention']} "
          f"(per decode step: {cfg.n_layers} attention, "
          f"{7 * cfg.n_layers} forest) | plans packed during the serve: "
          f"{packs}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    if packs:
        raise AssertionError(f"{packs} plans were packed while serving")
    # the same requests on the plain path: engine_torch (its own dense
    # DevicePlans through run_device) + gather decode
    pcfg = cfg.replace(quant=cfg.quant.with_(backend="engine_torch"),
                       paged_kernel=False)
    pmodel = Model(pcfg, device="cuda")
    pparams = pmodel.attach_device_plans(raw)
    before = (transitive_forest.launches, paged_attention.launches)
    peng, pdt = _serve(pmodel, pparams, prompts, 32, paged_kernel=False,
                       **kw)
    if (transitive_forest.launches, paged_attention.launches) != before:
        raise AssertionError("the plain path launched a kernel")
    ptoks = {r.rid: r.tokens for r in peng.finished}
    same = sum(a == b for rid in toks for a, b in zip(toks[rid], ptoks[rid]))
    first = sum(toks[rid][0] == ptoks[rid][0] for rid in toks)
    print(f"[main] plain path (engine_torch + gather): {pdt:.3f}s -> "
          f"{peng.report()['total_tokens'] / pdt:.1f} tokens/s | tokens "
          f"agreeing with the kernel path: {same}/{rep['total_tokens']} "
          f"({same / rep['total_tokens']:.3f}); first tokens {first}/8")
    return launches, toks, raw, params, cfg


def _thread_counts(main):
    """Count plan-cache builds (misses' builds), plan builds and packs made
    on the thread ``main`` while ``counts["on"]`` is set; returns (counts,
    undo)."""
    import repro_torch.core.backend as B
    from repro_torch.core import plancache
    from repro_torch.core.engine import BatchedTransitiveEngine
    counts = {"on": False, "cache_builds": 0, "plans": 0, "packs": 0}
    patched = [(plancache.PlanCache, "_build", "cache_builds"),
               (BatchedTransitiveEngine, "plan", "plans"),
               (B, "pack_forest_plan", "packs"),
               (B, "pack_sparse_forest_plan", "packs")]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in
             patched]

    def counted(real, key):
        def fn(*a, **kw):
            if counts["on"] and threading.current_thread() is main:
                counts[key] += 1
            return real(*a, **kw)
        return fn
    for (owner, name, key), (_, _, real) in zip(patched, saved):
        setattr(owner, name, counted(real, key))

    def undo():
        for owner, name, real in saved:
            setattr(owner, name, real)
    return counts, undo


class GateMeter:
    """Counts what the plan verifier verifies, per gate.

    Wraps ``repro_torch.analysis.planlint._run`` (one call per artifact:
    its findings) and each gate function, ``lint_plans`` and
    ``analysis.programs.lint_backend`` (the ``where`` that the runs inside
    it are counted under, on its own thread, and its seconds, parsing a
    bundle file included; inside ``lint_backend`` every gate counts under
    ``tracelint``). The package looks the gates up on the module at each
    call, so the wrappers see every gate of the serving path.
    :meth:`take` prints and returns what was counted since the last
    take."""

    GATES = ("gate_plan", "gate_device", "gate_manifest", "gate_bundle_file",
             "gate_params")
    # wheres that keep the gates run inside them: the tracelint programs
    # plan in a cache of their own, apart from the serving path's gates
    OUTER = ("tracelint",)

    def __init__(self):
        from repro_torch.analysis import planlint
        self.lock = threading.Lock()
        self.local = threading.local()
        self.counts = {}
        self.log = {}
        real_run = planlint._run

        def run(art, **kw):
            t = time.perf_counter()
            out = real_run(art, **kw)
            where = getattr(self.local, "where", None)
            self._add(where or "(no gate)", 1, len(out),
                      0.0 if where else time.perf_counter() - t)
            return out
        planlint._run = run
        for name in self.GATES:
            setattr(planlint, name, self._scoped(getattr(planlint, name)))
        planlint.lint_plans = self._scoped(planlint.lint_plans,
                                           "lint_plans")
        from repro_torch.analysis import programs
        programs.lint_backend = self._scoped(programs.lint_backend,
                                             "tracelint")

    def _add(self, where, artifacts, findings, s):
        with self.lock:
            c = self.counts.setdefault(
                where, {"artifacts": 0, "findings": 0, "s": 0.0})
            c["artifacts"] += artifacts
            c["findings"] += findings
            c["s"] += s

    def _scoped(self, real, fixed=None):
        def gate(*a, **k):
            prev = getattr(self.local, "where", None)
            where = prev if prev in self.OUTER else fixed or k["where"]
            self.local.where = where
            t = time.perf_counter()
            try:
                return real(*a, **k)
            finally:
                self.local.where = prev
                if prev not in self.OUTER:
                    self._add(where, 0, 0, time.perf_counter() - t)
        return gate

    def take(self, label):
        with self.lock:
            out, self.counts = self.counts, {}
        if out:
            self.log[label] = out
            print(f"[planlint] {label}: " + "; ".join(
                f"{w} {c['artifacts']} artifacts, {c['findings']} findings, "
                f"{c['s']:.2f}s" for w, c in sorted(out.items())))
        return out


_GATE_METER = []


def _gates() -> GateMeter:
    """The process's gate meter, installed at its first use."""
    if not _GATE_METER:
        _GATE_METER.append(GateMeter())
    return _GATE_METER[0]


def _gate(counted, where):
    """``counted[where]`` (zeros where the gate verified nothing)."""
    return counted.get(where, {"artifacts": 0, "findings": 0, "s": 0.0})


def fleet_path(raw, params0, cfg, toks5, bdir, device="cuda"):
    """Phase 18: the live-weight fleet on phase 5's model and workload
    (smollm-135m at full width and depth, W4A8 ``engine_cuda`` (B1) + B2,
    4 slots, page_size 16, max_len 256, 8 requests of 128-token prompts
    sharing prefixes, 32 tokens each).

    (a) Bundles: plan the model into ``write_bundles`` (a fresh plan
    cache: the planning is timed, 210 ``cache-publish`` verifications),
    load them on a fresh cache with zero lookups (the ``bundle-load``
    gate: the manifest, every file, every lowered ForestPlan), the packed
    ForestPlans equal phase 5's leaf for leaf, serve
    phase 5's requests: all 256 tokens equal; a stale bundle (one weight
    byte changed) and a damaged file (one byte flipped, even forced) are
    refused. (b) Hot swap under load: 4 requests admitted on generation 0,
    seed-1234 weights written as a checkpoint after 3 host steps, a
    ``WeightWatcher`` + ``ReplanWorker`` plan all 210 linears off the
    serving thread while decode goes on, 4 requests after the swap; each
    request's tokens equal its generation served alone on a fresh engine
    with the same admission schedule (``launch.serve.replay``); no plan
    build, cache miss or pack on the serving thread; B1 and B2 launch on
    both generations; one generation retired; host decode step times
    before, during and after the replan. (c) Refusals: a structurally
    different params tree raises ``SwapMismatchError``, a replan whose
    build raises fires ``on_error``; generation 0 serves on, its tokens
    phase 5's. The bundles stay in ``bdir`` for phase 22. Returns {run:
    {kernel: launches}} and the numbers."""
    import shutil
    import statistics

    import torch
    from repro_torch.analysis.planlint import PlanVerificationError
    from repro_torch.core import plancache
    from repro_torch.core.engine import BundleMismatchError, ForestPlan
    from repro_torch.core.plancache import _iter_ptq_layers
    from repro_torch.distributed import checkpoint
    from repro_torch.fleet import (ReplanWorker, WeightWatcher,
                                   fingerprint_params, load_bundles,
                                   write_bundles)
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.launch.serve import replay
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import SwapMismatchError

    model = Model(cfg, device=device)
    kw = dict(n_slots=4, max_len=256, page_size=16, paged_kernel=True)
    prompts = _prompts(cfg.vocab, 8, 128)
    kernels = (transitive_forest, paged_attention)
    work = os.path.join(ROOT, "build", "phase18")
    shutil.rmtree(work, ignore_errors=True)
    launches, numbers = {}, {}
    counts, undo = _thread_counts(threading.current_thread())
    try:
        # -- (a) bundles ----------------------------------------------------
        shutil.rmtree(bdir, ignore_errors=True)
        t0 = time.perf_counter()
        manifest = write_bundles(raw, cfg.quant, bdir,
                                 cache=plancache.PlanCache())
        t_plan = time.perf_counter() - t0
        n_bytes = sum(os.path.getsize(os.path.join(bdir, f))
                      for f in os.listdir(bdir))
        written = _gate(_gates().take("phase 18a (write_bundles)"),
                        "cache-publish")
        cache = plancache.PlanCache()
        prev = plancache.set_default_cache(cache)
        try:
            t0 = time.perf_counter()
            params = load_bundles(raw, cfg.quant, bdir)
            if device == "cuda":
                torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            looked = cache.stats()
        finally:
            plancache.set_default_cache(prev)
        print(f"[phase 18a] write_bundles: {manifest['n_files']} files "
              f"over {manifest['n_layers']} stacked layers, {n_bytes} B, "
              f"planned in {t_plan:.2f}s (of which the cache-publish "
              f"gate {written['artifacts']} plans, {written['findings']} "
              f"findings, {written['s']:.2f}s) | load_bundles in "
              f"{t_load:.2f}s "
              f"(read, SHA-256, checks, pack into ForestPlans, upload), "
              f"cache lookups {looked['hits'] + looked['misses']}")
        if manifest["n_files"] != 7 * cfg.n_layers or looked["misses"] \
                or looked["hits"]:
            raise AssertionError(f"phase 18a: {manifest['n_files']} files, "
                                 f"cache {looked}")
        # the manifest, each file's plan and DevicePlan, each stacked
        # layer's lowered ForestPlan
        loaded = _gate(_gates().take("phase 18a (load_bundles)"),
                       "bundle-load")
        want_n = 1 + 2 * manifest["n_files"] + manifest["n_layers"]
        print(f"[phase 18a] plan verifier: "
              f"{loaded['artifacts']} artifacts at bundle-load (manifest, "
              f"{manifest['n_files']} files x plan + DevicePlan, "
              f"{manifest['n_layers']} lowered ForestPlans; {want_n} "
              f"expected), {loaded['findings']} findings, "
              f"{loaded['s']:.2f}s of the {t_load:.2f}s load")
        if (loaded["artifacts"], loaded["findings"]) != (want_n, 0) or (
                written["artifacts"], written["findings"]) != (
                    manifest["n_files"], 0):
            raise AssertionError(f"phase 18a: the gates verified "
                                 f"{loaded} at load, {written} while "
                                 f"planning")
        numbers["plan_verifier"] = {"bundle_write": written,
                                    "bundle_load": loaded}
        got = list(_iter_ptq_layers(params))
        want = list(_iter_ptq_layers(params0))
        for a, b in zip(got, want):
            if not isinstance(a["dplan"], ForestPlan) or not all(
                    torch.equal(x, y) for x, y in zip(
                        a["dplan"].leaves().values(),
                        b["dplan"].leaves().values())):
                raise AssertionError("phase 18a: a loaded ForestPlan "
                                     "differs from attach_device_plans'")
        for k in kernels:
            k.launches = 0
        eng, dt = _serve(model, params, prompts, 32, **kw)
        launches["phase 18a (bundle server)"] = {
            k.__name__: k.launches for k in kernels}
        toks = {r.rid: r.tokens for r in eng.finished}
        same = sum(a == b for rid in toks
                   for a, b in zip(toks[rid], toks5[rid]))
        print(f"[phase 18a] bundle server: 8 requests x 32 tokens in "
              f"{dt:.3f}s, tokens equal to phase 5's: {same}/256 | "
              f"launches {launches['phase 18a (bundle server)']}")
        if toks != toks5:
            raise AssertionError(f"phase 18a: {same}/256 tokens equal")
        del eng
        stale = {**raw, "blocks": {**raw["blocks"], "b0": {
            **raw["blocks"]["b0"], "wq": {**raw["blocks"]["b0"]["wq"]}}}}
        qw = stale["blocks"]["b0"]["wq"]["qw"].clone()
        qw.view(-1)[0] ^= 1
        stale["blocks"]["b0"]["wq"]["qw"] = qw
        bad = os.path.join(work, "damaged")
        shutil.copytree(bdir, bad)
        victim = os.path.join(bad, manifest["layers"]["blocks/b0/wq"][
            "files"][0]["file"])
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        refused = []
        for name, fn in (
                ("stale", lambda: load_bundles(stale, cfg.quant, bdir)),
                ("damaged", lambda: load_bundles(raw, cfg.quant, bad,
                                                 force=True))):
            try:
                fn()
            except (BundleMismatchError, PlanVerificationError) as e:
                refused.append(f"{name}: {type(e).__name__}: "
                               f"{str(e)[:120]}")
            else:
                raise AssertionError(f"phase 18a: a {name} bundle loaded")
        print(f"[phase 18a] refused: {refused}")
        _gates().take("phase 18a (refusals)")
        del params, stale
        shutil.rmtree(bad)

        # -- (b) hot swap under load ----------------------------------------
        raw1 = model.init(1234)
        ckpt = os.path.join(work, "weights")
        eng = ServeEngine(model, params0, device=device, **kw)
        staged, errors = threading.Event(), []

        def on_ready(g):
            eng.swap_params(g.params, tag=g.tag)
            staged.set()
        worker = ReplanWorker(model, reference=params0, on_ready=on_ready,
                              on_error=errors.append)
        watcher = WeightWatcher(ckpt, raw, worker)
        by_gen = {0: [0, 0], 1: [0, 0]}
        decode = eng._decode

        def counted(cell, packed):
            before = [k.launches for k in kernels]
            decode(cell, packed)
            for i, k in enumerate(kernels):
                by_gen[cell.gen][i] += k.launches - before[i]
        eng._decode = counted
        steps = {"before": [], "during": [], "after": []}
        admitted, ticket, t_poll = {}, None, None
        submitted = host_step = 0
        counts["on"] = True
        try:
            while (submitted < 8 or eng.queue or eng.active
                   or (eng.generation == 0 and not errors)):
                if eng.generation == 0 and submitted < 4:
                    for p in prompts[:4]:           # 4 at once on gen 0
                        eng.submit(p, 32)
                    submitted = 4
                elif eng.generation == 1 and submitted < 8:
                    eng.submit(prompts[submitted], 32)   # one a step
                    submitted += 1
                if host_step == 3:
                    checkpoint.save(ckpt, 1, raw1)
                    t0 = time.perf_counter()
                    ticket = watcher.poll()
                    t_poll = time.perf_counter() - t0
                when = ("before" if ticket is None else "after"
                        if eng.generation == 1 else
                        "during" if not ticket.done else None)
                c = dict(eng.counters)
                t0 = time.perf_counter()
                eng.step()
                dt = time.perf_counter() - t0
                if (when and eng.counters["decode_steps"] > c["decode_steps"]
                        and eng.counters["admitted"] == c["admitted"]):
                    steps[when].append(dt)
                for r in [*eng.active.values(), *eng.finished]:
                    admitted.setdefault(r.rid, host_step)
                host_step += 1
                if (ticket is not None and eng.generation == 0
                        and not eng.active and not eng.queue):
                    # idle until the swap: no spinning beside the planner
                    if not (ticket.wait(timeout=600) and (
                            ticket.error is not None
                            or staged.wait(timeout=60))):
                        raise AssertionError("phase 18b: the replan never "
                                             "staged a swap")
        finally:
            counts["on"] = False
            worker.stop()
        if errors or ticket is None or ticket.error is not None:
            raise AssertionError(f"phase 18b: the replan failed: {errors}")
        gen1 = ticket.generation
        counted = _gates().take("phase 18b (replan + swap)")
        staging, publish = (_gate(counted, w) for w in ("swap-staging",
                                                        "cache-publish"))
        n_stacked = manifest["n_layers"]
        print(f"[phase 18b] plan verifier on the worker thread: "
              f"{publish['artifacts']} plans at cache-publish "
              f"({publish['s']:.2f}s of the {gen1.build_s:.2f}s replan), "
              f"{staging['artifacts']} stacked ForestPlans at swap-staging "
              f"({staging['s']:.3f}s), findings "
              f"{publish['findings'] + staging['findings']}")
        if (staging["artifacts"], publish["artifacts"]) != (
                n_stacked, gen1.plans_built) or staging["findings"] or \
                publish["findings"]:
            raise AssertionError(f"phase 18b: the gates verified {counted}")
        numbers["plan_verifier"] |= {"replan_publish": publish,
                                     "swap_staging": staging}
        s = eng.stats()
        med = {k: statistics.median(v) * 1e3 if v else float("nan")
               for k, v in steps.items()}
        print(f"[phase 18b] hot swap under load: checkpoint restored and "
              f"submitted on the serving thread in {t_poll:.2f}s; worker "
              f"build_s {gen1.build_s:.2f}s, {gen1.plans_built} plans; swap "
              f"applied at decode step {eng.swap_steps}; host decode step "
              f"ms, median (n): before the replan {med['before']:.2f} "
              f"({len(steps['before'])}), during {med['during']:.2f} "
              f"({len(steps['during'])}), after the swap "
              f"{med['after']:.2f} ({len(steps['after'])}) | launches by "
              f"generation (B1, B2) {by_gen} | serving-thread plan builds "
              f"{counts['plans']}, cache builds {counts['cache_builds']}, "
              f"packs {counts['packs']} | swaps {s['swaps']} retired "
              f"{s['generations_retired']} drift {s['swap_shape_drift']}")
        if gen1.plans_built != 7 * cfg.n_layers or gen1.fingerprint != \
                fingerprint_params(raw1):
            raise AssertionError(f"phase 18b: generation 1 {gen1.plans_built}"
                                 f" plans, fingerprint {gen1.fingerprint}")
        if counts["plans"] or counts["cache_builds"] or counts["packs"]:
            raise AssertionError(f"phase 18b: the serving thread built or "
                                 f"packed: {counts}")
        if not all(all(v) for v in by_gen.values()):
            raise AssertionError(f"phase 18b: B1/B2 not launched on both "
                                 f"generations: {by_gen}")
        if (s["generation"], s["swaps"], s["generations_retired"]) != \
                (1, 1, 1):
            raise AssertionError(f"phase 18b: {s}")
        gens = {g: [r for r in eng.finished if r.gen == g] for g in (0, 1)}
        if sorted(len(v) for v in gens.values()) != [4, 4]:
            raise AssertionError(f"phase 18b: requests by generation "
                                 f"{ {g: len(v) for g, v in gens.items()} }")
        alone, base = {}, {0: [], 1: []}
        real_step = ServeEngine.step
        for g, gparams in ((0, params0), (1, gen1.params)):
            def timed_step(self, _g=g):
                c = dict(self.counters)
                t0 = time.perf_counter()
                out = real_step(self)
                if (self.counters["decode_steps"] > c["decode_steps"]
                        and self.counters["admitted"] == c["admitted"]):
                    base[_g].append(time.perf_counter() - t0)
                return out
            ServeEngine.step = timed_step
            try:
                alone |= replay(model, gparams, gens[g], admitted, **kw)
            finally:
                ServeEngine.step = real_step
        alone_ms = {g: statistics.median(v) * 1e3 for g, v in base.items()}
        toks = {r.rid: r.tokens for r in eng.finished}
        same = sum(a == b for rid in toks
                   for a, b in zip(toks[rid], alone[rid]))
        print(f"[phase 18b] each generation served alone on a fresh engine "
              f"with the same admission schedule (no replan running): host "
              f"decode step ms, median (n): gen 0 {alone_ms[0]:.2f} "
              f"({len(base[0])}), gen 1 {alone_ms[1]:.2f} ({len(base[1])}) "
              f"| tokens equal to the swap run's: {same}/256")
        if toks != alone or any(len(t) != 32 for t in toks.values()):
            raise AssertionError(f"phase 18b: {same}/256 tokens equal")
        launches["phase 18b (hot swap)"] = {
            k.__name__: sum(v[i] for v in by_gen.values())
            for i, k in enumerate(kernels)}
        numbers["hot_swap"] = {
            "plan_s": t_plan, "bundle_load_s": t_load,
            "bundle_bytes": n_bytes, "worker_build_s": gen1.build_s,
            "poll_s": t_poll, "step_ms_median": med,
            "step_counts": {k: len(v) for k, v in steps.items()},
            "alone_step_ms_median": alone_ms,
            "launches_by_generation": by_gen}
        del eng, gen1, raw1, worker, watcher

        # -- (c) refusals ---------------------------------------------------
        eng = ServeEngine(model, params0, device=device, **kw)
        try:
            eng.swap_params(raw)                # no plans attached
        except SwapMismatchError:
            pass
        else:
            raise AssertionError("phase 18c: a mismatched swap staged")
        errors = []
        bad = {**raw, "blocks": {**raw["blocks"], "b0": {
            **raw["blocks"]["b0"], "wq": {**raw["blocks"]["b0"]["wq"]}}}}
        bad["blocks"]["b0"]["wq"]["qw"] = bad["blocks"]["b0"]["wq"][
            "qw"].to(torch.int32) * 1000       # outside int8: cannot plan
        with ReplanWorker(model, reference=params0,
                          on_ready=lambda g: eng.swap_params(g.params),
                          on_error=errors.append) as w:
            ticket = w.submit(bad)
            for k in kernels:
                k.launches = 0
            for p in prompts:
                eng.submit(p, 32)
            eng.run()
            if not ticket.wait(timeout=120):
                raise AssertionError("phase 18c: the replan never ended")
        launches["phase 18c (refusals)"] = {
            k.__name__: k.launches for k in kernels}
        toks = {r.rid: r.tokens for r in eng.finished}
        print(f"[phase 18c] SwapMismatchError raised, staged "
              f"{eng.counters['swaps_staged']}; failed replan: on_error "
              f"{[type(e).__name__ for e in errors]}; generation "
              f"{eng.generation} served on, tokens equal to phase 5's: "
              f"{toks == toks5}")
        if (len(errors) != 1 or ticket.error is not errors[0]
                or eng.generation or eng.counters["swaps_staged"]
                or toks != toks5):
            raise AssertionError(f"phase 18c: errors {errors}, generation "
                                 f"{eng.generation}, {eng.counters}")
    finally:
        undo()
        shutil.rmtree(work, ignore_errors=True)
    return launches, numbers


def _mesh_rank(bdir, toks5, lint_argv):
    """Phase 22 on one rank of the ``data=2`` world: phase 5's weights
    (``Model.init(0)``, the same draw on every rank), their plans from
    phase 18a's bundles placed on the mesh, phase 5's requests through
    ``ServeEngine(mesh=)`` on ``engine_cuda`` + B2, then the lint under
    the mesh. Returns this rank's numbers (the parent prints them)."""
    import contextlib
    import io

    import torch
    import torch.distributed as dist
    from repro_torch.analysis import lint
    from repro_torch.configs import get_config
    from repro_torch.core import plancache
    from repro_torch.distributed.sharding import batch_index
    from repro_torch.fleet import load_bundles
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.launch.specs import mesh_serve_report, serve_config
    from repro_torch.models.model import Model
    t_start = time.perf_counter()
    cfg = serve_config(get_config("smollm_135m"),
                       backend="engine_cuda").replace(paged_kernel=True)
    model = Model(cfg, device="cuda")
    raw = model.init(0)
    mesh = make_serve_mesh("data=2", device="cuda")
    cache = plancache.PlanCache()
    plancache.set_default_cache(cache)
    t0 = time.perf_counter()
    params = load_bundles(raw, cfg.quant, bdir, mesh=mesh)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    loaded = cache.stats()
    del raw
    kernels = (transitive_forest, paged_attention)
    for k in kernels:
        k.launches = 0
    eng, dt = _serve(model, params, _prompts(cfg.vocab, 8, 128), 32,
                     n_slots=4, max_len=256, page_size=16, mesh=mesh,
                     paged_kernel=True)
    launches = {k.__name__: k.launches for k in kernels}
    served = cache.stats()                 # load and serve, cumulative
    toks = {r.rid: r.tokens for r in eng.finished}
    rep = eng.report()
    k = eng.n_slots // mesh.size()
    i = batch_index(mesh)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(),
           "device": str(torch.device("cuda", torch.cuda.current_device())),
           "slot_rows": [i * k, (i + 1) * k], "launches": launches,
           "default_cache": plancache.default_cache() is cache,
           "builds": [loaded["misses"], served["misses"]],
           "lookups": [loaded["hits"] + loaded["misses"],
                       served["hits"] + served["misses"]],
           "load_s": t_load, "serve_s": dt,
           "same": sum(a == b for rid in toks
                       for a, b in zip(toks[rid], toks5[rid])),
           "tokens_equal": toks == toks5,
           "placements": {name: [str(p) for p in pl] for name, pl in
                          eng.decode_placements.items()},
           "report": mesh_serve_report(mesh, eng.n_slots, rep["n_requests"],
                                       rep["total_tokens"],
                                       rep["counters"]["decode_steps"], dt),
           "plans_placed": {str(a.placements) for layer in
                            plancache._iter_ptq_layers(params)
                            for a in layer["dplan"].leaves().values()}}
    del eng, params
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["lint_rc"] = lint.main(list(lint_argv))
    out["lint_s"] = time.perf_counter() - t0
    out["lint_out"] = buf.getvalue()
    out["seconds"] = time.perf_counter() - t_start
    return out


def mesh_path(toks5, bdir):
    """Phase 22: the data-parallel serve cell on the one card. Two ranks
    (``launch.mesh.RankWorld``: spawned processes in one ``gloo`` group;
    NCCL refuses two ranks on one GPU, and ``gloo``'s collectives on CUDA
    tensors are partial, so the step's token and K/V exchange goes through
    the host) each serve smollm-135m at its published widths and all 30
    layers on ``engine_cuda`` (B1 for every linear) and B2 (every packed
    decode) with bucketed prefill, phase 5's engine settings and
    requests, a ``data=2`` mesh splitting the 4 slots two a rank; plans
    from phase 18a's bundles (``load_bundles(mesh=)``: 0 plan builds and
    0 lookups on any rank, through the load and the serve). All 256 tokens must equal phase 5's on every rank; B1 and
    B2 must launch on every rank. Then ``python -m
    repro_torch.analysis.lint --mesh data=2 --backend engine_cuda`` on
    ``cuda`` across the two ranks: exit 0, 0 findings,
    ``sharding-integrity`` evaluated. Returns {run: {kernel: launches}}.
    """
    from repro_torch.launch.mesh import run_ranks
    lint_argv = ["--mesh", "data=2", "--backend", "engine_cuda",
                 "--device", "cuda"]
    t0 = time.perf_counter()
    got = run_ranks(2, _mesh_rank, bdir, toks5, lint_argv, timeout=600)
    launches = {}
    for r in got:
        print(f"[phase 22] rank {r['rank']} ({r['backend']}, {r['device']}, "
              f"slot rows {r['slot_rows'][0]}..{r['slot_rows'][1] - 1}): "
              f"load_bundles(mesh=) {r['load_s']:.2f}s, plan builds "
              f"{r['builds'][0]} (load) {r['builds'][1]} (load and serve), "
              f"cache lookups {r['lookups'][0]} (load) {r['lookups'][1]} "
              f"(load and serve), plan leaves "
              f"{sorted(r['plans_placed'])} | served 8 requests x 32 "
              f"tokens in {r['serve_s']:.3f}s, tokens equal to phase 5's: "
              f"{r['same']}/256 | launches {r['launches']} | packed "
              f"decode placements {r['placements']} | lint "
              f"{r['lint_s']:.1f}s exit {r['lint_rc']} | rank "
              f"{r['seconds']:.1f}s")
        print(f"[phase 22] rank {r['rank']} {r['report']}")
        launches[f"phase 22 (data=2 mesh, rank {r['rank']})"] = r["launches"]
    lint_out = got[0]["lint_out"]
    for line in lint_out.strip().splitlines():
        print(f"[phase 22] {line}")
    print(f"[phase 22] {time.perf_counter() - t0:.1f}s with the ranks' "
          f"start")
    for r in got:
        if not r["tokens_equal"] or any(r["builds"]) or any(r["lookups"]) \
                or not r["default_cache"] or not all(
                r["launches"].values()) or r["lint_rc"] or r["backend"] != \
                "gloo" or r["plans_placed"] != {"(Replicate(),)"}:
            raise AssertionError(f"phase 22: rank {r['rank']}: {r}")
    if "sharding-integrity evaluated on 1 program(s) (decode) under mesh " \
            "data=2 (2 ranks)" not in lint_out or \
            "on mesh data=2: 0 finding(s)" not in lint_out:
        raise AssertionError(f"phase 22: lint under the mesh: {lint_out}")
    return launches


def lut_path(toks_engine, raw, cfg):
    """The LUT serving path: the same model and requests served on lut_cuda
    (the doubling-LUT kernel B3, no plan) with the paged-attention kernel.
    Over the run B3 and B2 launch, B1 does not, the plan cache sees no
    lookup, and every token equals the engine_cuda run's: both backends
    give the same int32 accumulators."""
    from repro_torch.core import plancache
    from repro_torch.core.engine import DevicePlan, ForestPlan
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.models.model import Model
    lcfg = cfg.replace(quant=cfg.quant.with_(backend="lut_cuda"))
    model = Model(lcfg, device="cuda")
    for blk in raw["blocks"].values():
        for layer in blk.values():
            if isinstance(layer, dict) and isinstance(
                    layer.get("dplan"), (DevicePlan, ForestPlan)):
                raise AssertionError("lut_cuda params carry a plan")
    cache = plancache.default_cache().stats()
    prompts = _prompts(lcfg.vocab, 8, 128)
    kw = dict(n_slots=4, max_len=256, page_size=16)
    kernels = (transitive_forest, transitive_gemm_cuda, paged_attention)
    for k in kernels:
        k.launches = 0
    eng, dt = _serve(model, raw, prompts, 32, paged_kernel=True, **kw)
    launches = {k.__name__: k.launches for k in kernels}
    after = plancache.default_cache().stats()
    rep = eng.report()
    c = rep["counters"]
    ttft = sum(r["ttft_s"] for r in rep["requests"]) / len(rep["requests"])
    toks = {r.rid: r.tokens for r in eng.finished}
    print(f"[lut] {lcfg.name} on lut_cuda + paged kernel: 8 requests x 32 "
          f"tokens in {dt:.3f}s -> {rep['total_tokens'] / dt:.1f} "
          f"tokens/s | mean TTFT {ttft * 1e3:.1f} ms | decode steps "
          f"{c['decode_steps']} | launches: transitive_gemm="
          f"{launches['transitive_gemm_cuda']} paged_attention="
          f"{launches['paged_attention']} transitive_forest="
          f"{launches['transitive_forest']} | plan cache hits+misses "
          f"{cache['hits'] + cache['misses']} -> "
          f"{after['hits'] + after['misses']}")
    if not (launches["transitive_gemm_cuda"] and launches["paged_attention"]
            and launches["transitive_forest"] == 0):
        raise AssertionError(f"lut_cuda path launches wrong: {launches}")
    if (after["hits"], after["misses"]) != (cache["hits"], cache["misses"]):
        raise AssertionError(f"lut_cuda path touched the plan cache: "
                             f"{cache} -> {after}")
    same = sum(a == b for rid in toks
               for a, b in zip(toks[rid], toks_engine[rid]))
    total = sum(map(len, toks_engine.values()))
    print(f"[lut] tokens equal to the engine_cuda run: {same}/{total}")
    if toks != toks_engine:
        raise AssertionError(f"lut_cuda tokens differ from engine_cuda's: "
                             f"{same}/{total} equal")
    return launches


def layout_paths(raw, cfg):
    """B2's three other pool layouts on full-width serving paths: the same
    8 requests as phases 5-6 (4 slots, page_size 16, max_len 256,
    128-token prompts, 32 tokens each) with ``paged_kernel=True``:

      8. ``--fp``: the base config unquantized (bf16 ``torch.matmul``
         linears, exact bf16 pool, float attention), its own weights from
         seed 0: layout 2;
      9. W4A8 on ``lut_cuda`` (phase 6's weights), int8 pool, float
         attention: layout 3;
     10. W4A8 on ``lut_cuda``, exact bf16 pool, int8 attention: layout 1.

    Each asserts that B2 launched once per layer per decode step, then
    serves the same requests on the gather path and prints the share of
    tokens the two agree on; where they part, the teacher-forced logit
    differences and top-2 margins (``_partings``); and, from a third run,
    how far B2 lay from its plain version on the serving path's own
    inputs (asserted within the loose bound of ``agreement``). Returns
    {layout: (launches, phase name)}."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import LAYOUTS, paged_attention
    from repro_torch.models.model import Model
    lcfg = cfg.replace(quant=cfg.quant.with_(backend="lut_cuda"))
    phases = [
        ("phase 8 (--fp serve)",
         get_config("smollm_135m").replace(paged_kernel=True), None),
        ("phase 9 (lut_cuda, KV8, float attention)",
         lcfg.replace(kv_cache_bits=8, quant_attention=False), raw),
        ("phase 10 (lut_cuda, exact KV, int8 attention)",
         lcfg.replace(kv_cache_bits=16, quant_attention=True), raw)]
    kw = dict(n_slots=4, max_len=256, page_size=16)
    out = {}
    for phase, pcfg, params in phases:
        model = Model(pcfg, device="cuda")
        if params is None:
            params = model.init(0)
        kv8 = pcfg.kv_cache_bits == 8
        layout, name = LAYOUTS[(pcfg.quant_attention, kv8)]
        pool_dtype = torch.int8 if kv8 else pcfg.dtype
        prompts = _prompts(pcfg.vocab, 8, 128)
        paged_attention.launches = 0
        trace_k, trace_g = [], []
        eng, dt = _serve(model, params, prompts, 32, paged_kernel=True,
                         trace=trace_k, **kw)
        launches = paged_attention.launches
        rep = eng.report()
        c = rep["counters"]
        toks = {r.rid: r.tokens for r in eng.finished}
        if sorted(len(t) for t in toks.values()) != [32] * 8 or not all(
                0 <= t < pcfg.vocab for ts in toks.values() for t in ts):
            raise AssertionError(f"{phase}: output malformed: {toks}")
        want = pcfg.n_layers * c["decode_steps"]
        ttft = sum(r["ttft_s"] for r in rep["requests"]) / len(
            rep["requests"])
        print(f"[{phase}] {name}, pool {pool_dtype}: 8 "
              f"requests x 32 tokens in {dt:.3f}s -> "
              f"{rep['total_tokens'] / dt:.1f} tokens/s | mean TTFT "
              f"{ttft * 1e3:.1f} ms | decode steps {c['decode_steps']} | "
              f"paged_attention launches {launches} (want {pcfg.n_layers} "
              f"layers x {c['decode_steps']} steps = {want})")
        if launches != want:
            raise AssertionError(f"{phase}: B2 launched {launches} times, "
                                 f"not once per layer per decode step "
                                 f"({want})")
        peng, pdt = _serve(model, params, prompts, 32, paged_kernel=False,
                           trace=trace_g, **kw)
        if paged_attention.launches != launches:
            raise AssertionError(f"{phase}: the gather path launched B2")
        ptoks = {r.rid: r.tokens for r in peng.finished}
        same = sum(a == b for rid in toks
                   for a, b in zip(toks[rid], ptoks[rid]))
        total = rep["total_tokens"]
        # greedy decoding feeds each token back: after the first token the
        # two paths disagree on, the rest of that request may differ too
        lead = [next((i for i, (a, b) in enumerate(zip(toks[rid],
                                                       ptoks[rid]))
                      if a != b), 32) for rid in sorted(toks)]
        print(f"[{phase}] gather path: {pdt:.3f}s | tokens agreeing with "
              f"the kernel path: {same}/{total} ({same / total:.3f}); "
              f"tokens before each request's first disagreement: {lead}")
        diffs, partings, margins = _partings(trace_k, trace_g)
        top = max(float(lg.abs().max()) for _, lg in trace_g)
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        print(f"[{phase}] teacher-forced, {len(diffs)} agreeing (step, "
              f"request) rows: max |logit diff| per row median "
              f"{float(diffs.median()):.4g}, max {float(diffs.max()):.4g}, "
              f"rows with 0: {int((diffs == 0).sum())} | gather top-2 "
              f"margin median {float(margins.median()):.4g}, min "
              f"{float(margins.min()):.4g} | bf16 ulp at max|logit| "
              f"{top:.3g}: {ulp:.4g}")
        print(f"[{phase}] first partings (request, token index, gather "
              f"top-2 margin, kernel top-2 margin, max |logit diff| of "
              f"the row): " + "; ".join(
                  f"({r}, {i}, {mg:.4g}, {mk:.4g}, {d:.4g})"
                  for r, i, mg, mk, d in partings))
        stoks, stats = _serve_shadowed(model, params, prompts, 32, **kw)
        beyond = [a["rows_beyond"] for a in stats]
        print(f"[{phase}] kernel beside its plain version on the serving "
              f"path's own inputs, {len(stats)} calls: rows beyond the "
              f"tight bound {sum(beyond)}/{sum(a['rows'] for a in stats)} "
              f"(calls with any {sum(n > 0 for n in beyond)}, most in one "
              f"call {max(beyond)}), max |diff| "
              f"{max(a['max_abs_err'] for a in stats):.4g}, worst |diff| / "
              f"loose bound {max(a['worst_loose'] for a in stats):.3g} | "
              f"tokens equal to the kernel run's: {stoks == toks}")
        if max(a["worst_loose"] for a in stats) > 1:
            raise AssertionError(f"{phase}: B2 beyond its loose bound on "
                                 f"the serving path's inputs")
        out[layout] = (launches, phase)
        del model, params, eng, peng
        torch.cuda.empty_cache()
    return out


def _plan_one_linear(qcfg, layer):
    """Host planning of one stacked linear (a one-entry ``{"qw", "sg"}``
    slice) for ``engine_cuda`` at the config's T, into a fresh plan cache:
    (seconds to plan, seconds to lower, pack and upload, ForestPlan bytes
    on the card, the int8 weight's bytes)."""
    import torch
    from repro_torch.core import plancache
    cache = plancache.PlanCache()
    qcfg = qcfg.with_(backend="engine_cuda")
    t0 = time.perf_counter()
    plancache.precompile({"w": layer}, qcfg, cache=cache)
    t_plan = time.perf_counter() - t0
    t0 = time.perf_counter()
    fplan = plancache.attach_device_plans({"w": layer}, qcfg,
                                          cache=cache)["w"]["dplan"]
    torch.cuda.synchronize()
    return (t_plan, time.perf_counter() - t0, fplan.nbytes(),
            layer["qw"].numel())


def _moe_stats(cfg, routed, steps):
    """Print the distinct experts each MoE layer's decode call hit (from
    the expert ids of every decode step's ``n_layers`` calls, in order) and
    the expert bytes that makes a step read, and their time at the card's
    memory rate."""
    hit = [int(e.unique().numel()) for e in routed]
    if len(hit) != cfg.n_layers * steps:
        raise AssertionError(f"{len(hit)} MoE decode calls, not {cfg.n_layers}"
                             f" layers x {steps} steps")
    per_expert = 3 * cfg.d_model * cfg.d_ff * cfg.dtype.itemsize
    gb = sum(hit) * per_expert / steps / 1e9
    print(f"  decode: {sum(hit) / len(hit):.2f} distinct experts per layer "
          f"per step (max {max(hit)} of {cfg.n_experts}; top-{cfg.top_k} of "
          f"each slot) -> {gb:.3f} GB of expert weights read per step "
          f"({per_expert / 1e6:.1f} MB per expert), "
          f"{gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")


def serve_arch(arch, phase, n_layers=None,
               cut="the phase shares chip_smoke's time limit"):
    """One architecture at its published widths (depth cut to ``n_layers``
    where given, printed with ``cut``, the reason) served on ``lut_cuda``
    (B3) with the paged-attention kernel (B2): W4A8 per-channel linears,
    int8 attention,
    KV8 pool, bf16, random weights from seed 0 drawn on the card
    (``Model.init(on_device=True)``); phase 5's workload (4 slots,
    page_size 16, max_len 256, 8 requests of 128-token prompts sharing
    prefixes, 32 tokens each). Over that run B3 launches, B2 launches
    once per layer per decode step, B1 (all three kernels) does not, and
    the plan cache sees no lookup. Then the same requests on ``int_dot``
    (an exact float64 integer GEMM) with B2: every token equal, since both
    backends give the same int32 accumulators and the same attention
    kernel runs. For an MoE config (the experts run in bf16 through
    ``torch._grouped_mm`` in both runs) it also prints the distinct experts
    hit per layer and decode step, with the bytes they make a step read,
    and, in the ``int_dot`` run, the host syncs inside the model's decode
    step (``torch.cuda``'s sync debug mode). Returns ({kernel: launches},
    cfg, params)."""
    import warnings

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import plancache
    from repro_torch.kernels.paged_attention import (launch_plan,
                                                     paged_attention)
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.launch.specs import serve_config
    from repro_torch.models import blocks as B
    from repro_torch.models.model import Model
    full = get_config(arch)
    cfg = serve_config(full, backend="lut_cuda").replace(paged_kernel=True)
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, on_device=True)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g = cfg.n_heads // cfg.n_kv_heads
    plan = launch_plan(16, 16, g, cfg.hd, 1, True, True)
    depth = (f"{cfg.n_layers} layers (cut from {full.n_layers}: {cut})"
             if n_layers is not None
             else f"{cfg.n_layers} layers (full depth)")
    moe = cfg.family == "moe"
    experts = (f"{cfg.n_experts} experts top-{cfg.top_k}"
               f"{' + shared' if cfg.n_shared_experts else ''} ({cfg.dtype}) "
               if moe else "")
    print(f"[{phase}] {cfg.name}: {depth}, d_model={cfg.d_model} heads="
          f"{cfg.n_heads}/{cfg.n_kv_heads} (G={g}: B2 in {plan.head_blocks} "
          f"block(s) of {plan.heads} query heads per KV head) hd={cfg.hd} "
          f"d_ff={cfg.d_ff} {experts}vocab={cfg.vocab} "
          f"{'tied' if cfg.tie_embeddings else 'untied'} "
          f"qk_norm={cfg.qk_norm} rope_2d={cfg.rope_2d} dtype={cfg.dtype} | "
          f"init on the card {t_init:.2f}s, {peak:.2f} GiB peak")
    prompts = _prompts(cfg.vocab, 8, 128)
    kw = dict(n_slots=4, max_len=256, page_size=16)
    kernels = (transitive_gemm_cuda, paged_attention, transitive_forest,
               transitive_forest_dense, launch_sparse)
    routed, in_decode = [], [False]
    local, step = B._moe_local, model.decode_step_paged

    def record(x2, gates, eids, *w):        # keeps the ids: no sync here
        if in_decode[0]:
            routed.append(eids)
        return local(x2, gates, eids, *w)

    def decode(*a, **k):
        in_decode[0] = True
        try:
            return step(*a, **k)
        finally:
            in_decode[0] = False
    if moe:
        B._moe_local, model.decode_step_paged = record, decode
    cache = plancache.default_cache().stats()
    for k in kernels:
        k.launches = 0
    try:
        eng, dt = _serve(model, params, prompts, 32, paged_kernel=True, **kw)
    finally:
        B._moe_local = local
        if moe:
            del model.decode_step_paged
    launches = {k.__name__: k.launches for k in kernels}
    after = plancache.default_cache().stats()
    rep = eng.report()
    c = rep["counters"]
    ttft = sum(r["ttft_s"] for r in rep["requests"]) / len(rep["requests"])
    toks = {r.rid: r.tokens for r in eng.finished}
    if sorted(len(t) for t in toks.values()) != [32] * 8 or not all(
            0 <= t < cfg.vocab for ts in toks.values() for t in ts):
        raise AssertionError(f"{phase}: output malformed: {toks}")
    want_b2 = cfg.n_layers * c["decode_steps"]
    print(f"[{phase}] lut_cuda + paged kernel: 8 requests x 32 tokens in "
          f"{dt:.3f}s -> {rep['total_tokens'] / dt:.1f} tokens/s | mean "
          f"TTFT {ttft * 1e3:.1f} ms | decode steps {c['decode_steps']} | "
          f"prefix hits={c['prefix_hits']} pages_shared="
          f"{c['pages_shared']} | launches: {launches} (B2 want "
          f"{cfg.n_layers} layers x {c['decode_steps']} steps = {want_b2}) "
          f"| plan cache hits+misses {cache['hits'] + cache['misses']} -> "
          f"{after['hits'] + after['misses']}")
    if not launches["transitive_gemm_cuda"]:
        raise AssertionError(f"{phase}: B3 never launched")
    if launches["paged_attention"] != want_b2:
        raise AssertionError(f"{phase}: B2 launched "
                             f"{launches['paged_attention']} times, not once "
                             f"per layer per decode step ({want_b2})")
    if any(launches[k.__name__] for k in kernels[2:]):
        raise AssertionError(f"{phase}: a B1 kernel launched: {launches}")
    if (after["hits"], after["misses"]) != (cache["hits"], cache["misses"]):
        raise AssertionError(f"{phase}: lut_cuda touched the plan cache")
    if moe:
        _moe_stats(cfg, routed, c["decode_steps"])
        del routed
    icfg = cfg.replace(quant=cfg.quant.with_(backend="int_dot"))
    imodel = Model(icfg, device="cuda")
    syncs, sites, istep = [], {}, imodel.decode_step_paged

    def counted(*a, **k):                   # host syncs inside the step
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return istep(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                hit = [x for x in w if "synchronizing" in str(x.message)]
                syncs.append(len(hit))
                for x in hit:               # the line that called the op
                    site = f"{os.path.basename(x.filename)}:{x.lineno}"
                    sites[site] = sites.get(site, 0) + 1
    if moe:
        imodel.decode_step_paged = counted
    before = [k.launches for k in kernels]
    ieng, idt = _serve(imodel, params, prompts, 32, paged_kernel=True, **kw)
    b3 = transitive_gemm_cuda.launches - before[0]
    itoks = {r.rid: r.tokens for r in ieng.finished}
    same = sum(a == b for rid in toks for a, b in zip(toks[rid], itoks[rid]))
    print(f"[{phase}] int_dot (float64 integer GEMM) + paged kernel: "
          f"{idt:.3f}s -> {ieng.report()['total_tokens'] / idt:.1f} "
          f"tokens/s | tokens equal to the lut_cuda run: {same}/"
          f"{rep['total_tokens']} | B3 launches {b3}")
    if moe:
        print(f"  host syncs inside the model's decode step (sync debug "
              f"mode, int_dot run): {sum(syncs) / len(syncs):.2f}"
              f" per step, min {min(syncs)} max {max(syncs)} over "
              f"{len(syncs)} steps ({cfg.n_layers} MoE layers); by the line "
              f"that called the op, per step: " + ", ".join(
                  f"{site} {n / len(syncs):.2f}" for site, n in
                  sorted(sites.items(), key=lambda kv: -kv[1])))
    if itoks != toks or b3:
        raise AssertionError(f"{phase}: int_dot + B2 tokens differ from "
                             f"lut_cuda + B2 ({same}/{rep['total_tokens']} "
                             f"equal; B3 launched {b3} times there)")
    return launches, cfg, params


def dense_paths():
    """Phase 11: llama1-7b (the paper's evaluation model) at full width and
    depth through ``serve_arch``, then the host planning of one of its
    q-projections (4096 x 4096) for ``engine_cuda`` at T = 8, timed. Phase
    11b: qwen3-14b (G=5), mistral-nemo-12b (G=4) and chatglm3-6b (G=16)
    at their published widths, depth cut to 4 layers, each freed before
    the next is built. Returns {phase: launches}."""
    import torch
    out = {}
    launches, cfg, params = serve_arch("llama1_7b", "phase 11")
    wq = params["blocks"]["b0"]["wq"]
    t_plan, t_pack, fbytes, wbytes = _plan_one_linear(
        cfg.quant, {"qw": wq["qw"][:1], "sg": wq["sg"][:1]})
    print(f"[phase 11] engine_cuda planning of one llama1-7b q-projection "
          f"(N=4096, K=4096, w_bits 4, T={cfg.quant.transrow_t}) on the "
          f"host: plan {t_plan:.2f}s, lower + pack + upload {t_pack:.2f}s | "
          f"ForestPlan {fbytes} B on the card ({fbytes / wbytes:.3f} x the "
          f"int8 weight, {wbytes} B); x {7 * cfg.n_layers} linears of "
          f"this model")
    out["phase 11 (llama1-7b, lut_cuda)"] = launches
    del params
    torch.cuda.empty_cache()
    for arch, g in (("qwen3_14b", 5), ("mistral_nemo_12b", 4),
                    ("chatglm3_6b", 16)):
        launches, cfg, params = serve_arch(arch, "phase 11b", n_layers=4)
        if cfg.n_heads // cfg.n_kv_heads != g:
            raise AssertionError(f"{arch}: G={cfg.n_heads // cfg.n_kv_heads}"
                                 f", not the published {g}")
        out[f"phase 11b ({arch}, lut_cuda)"] = launches
        del params
        torch.cuda.empty_cache()
    return out


def moe_paths():
    """Phase 13: moonshot-v1-16b-a3b at full width and depth through
    ``serve_arch`` (its 48 layers of 64 bf16 experts, 53.2 GB, fit the
    card); phase 13b: llama4-maverick-400b-a17b at its published widths,
    depth cut to 1 layer (128 experts of 5120 x 8192, 32.2 GB a layer,
    and a shared expert on B3), moonshot freed first. Returns {phase:
    launches}."""
    import torch
    out = {}
    for arch, phase, layers, cut in (
            ("moonshot_v1_16b_a3b", "phase 13", None, None),
            ("llama4_maverick_400b_a17b", "phase 13b", 1,
             "400B parameters do not fit one card's 80 GB; one layer "
             "holds 32.2 GB of experts")):
        kw = {} if layers is None else {"n_layers": layers, "cut": cut}
        launches, cfg, params = serve_arch(arch, phase, **kw)
        out[f"{phase} ({cfg.name}, lut_cuda)"] = launches
        del params
        torch.cuda.empty_cache()
    return out


def recurrent_path(flush):
    """Phase 12: recurrentgemma-9b at full width and depth (38 layers: 12
    repeats of (rglru, rglru, attn) and a tail of two rglru, d_model 4096,
    16 heads over 1 KV head, hd 256, d_ff 12288, vocab 256000 tied, local
    window 2048, bf16, W4A8 per-channel linears on ``lut_cuda``, int8
    attention, KV8 caches; random weights from seed 0 drawn on the card),
    served as the reference serves it: one-shot ``greedy_generate`` over
    dense, layer-stacked caches (the paged engine refuses the config). Two
    runs: (a) B = 4, 128-token prompts, 32 tokens; (b) B = 1, one
    2,100-token prompt, 16 tokens (its prefill takes ``attend_chunked``
    with the window, its decode writes positions 2100-2115 into slots
    52-67 of the 2048-slot rolling caches). Over each, with the counts set
    to 0 just before: B5 launches once per RG-LRU block (26) in the
    prefill and nowhere else, B3 launches, B1 and B2 do not, the plan
    cache sees no lookup. Each run again on ``int_dot`` (float64 integer
    GEMM, same params): every token equal. One block's (a, b) captured
    from each run goes through B5 and its plain version: bit-equal; B5's
    launch plan and the profiler's device us per call at those inputs.
    Returns (launches by run, B5's numbers by run)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.rg_lru import (launch_plan, rg_lru_cuda,
                                            rg_lru_plain)
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    cfg = serve_config(get_config("recurrentgemma_9b"), backend="lut_cuda")
    kinds = cfg.block_pattern * cfg.n_repeats + cfg.block_tail
    n_rglru = kinds.count("rglru")
    if (cfg.n_layers, len(kinds), n_rglru) != (38, 38, 26):
        raise AssertionError(f"phase 12: {cfg.n_layers} layers, "
                             f"{n_rglru} RG-LRU blocks")
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, on_device=True)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    print(f"[phase 12] {cfg.name}: {cfg.n_layers} layers (full depth: "
          f"{cfg.n_repeats} x {cfg.block_pattern} + tail "
          f"{cfg.block_tail}; {n_rglru} RG-LRU, "
          f"{kinds.count('attn')} local attention), d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff="
          f"{cfg.d_ff} vocab={cfg.vocab} tied window={cfg.local_window} "
          f"dtype={cfg.dtype} | paged path: {model.supports_paged()} | "
          f"init on the card {t_init:.2f}s, "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB peak")
    kernels = _oneshot_kernels()
    icfg = cfg.replace(quant=cfg.quant.with_(backend="int_dot"))
    launches, b5 = {}, {}
    for run, (b, s, gen) in (("a", (4, 128, 32)), ("b", (1, 2100, 16))):
        tokens = torch.from_numpy(np.random.default_rng(s).integers(
            0, cfg.vocab, size=(b, s)))
        tag = f"phase 12 ({run}) B={b} S={s} -> {gen}"
        captured, scan = [], ops.rg_lru

        def capture(x, a, h0):
            if not captured:            # the first block of the body
                captured.append((x.clone(), a.clone(), h0.clone()))
            return scan(x, a, h0)
        ops.rg_lru = capture
        try:
            toks, got, _, nums = _oneshot_run(tag, model, params,
                                              {"tokens": tokens}, gen,
                                              kernels)
        finally:
            ops.rg_lru = scan
        if got["rg_lru_cuda"] != n_rglru:
            raise AssertionError(f"{tag}: B5 launched {got['rg_lru_cuda']} "
                                 f"times, not once per RG-LRU block "
                                 f"({n_rglru})")
        if not got["transitive_gemm_cuda"]:
            raise AssertionError(f"{tag}: B3 never launched")
        if any(got[k.__name__] for k in kernels[1:5]):
            raise AssertionError(f"{tag}: B1 or B2 launched: {got}")
        launches[tag] = got
        itoks, igot, _, _ = _oneshot_run(tag, Model(icfg, device="cuda"),
                                         params, {"tokens": tokens}, gen,
                                         kernels)
        if igot["transitive_gemm_cuda"]:
            raise AssertionError(f"{tag}: int_dot launched B3: {igot}")
        _same_tokens(tag, toks, itoks, "int_dot (float64 integer GEMM)")
        x, a, h0 = captured[0]
        want = rg_lru_plain(x, a, h0)
        have = rg_lru_cuda(x, a, h0)
        torch.cuda.synchronize()
        if have.dtype != torch.float32 or not torch.equal(have, want):
            raise AssertionError(
                f"{tag}: B5 on the path's own (a, b) not bit-equal to its "
                f"plain version, max |diff| "
                f"{float((have - want).abs().max())}")
        plan = launch_plan(b, s, cfg.d_model, 4, 4, 4, x.data_ptr(),
                           a.data_ptr(), have.data_ptr())
        dev, ker, n_ops = device_us(lambda: rg_lru_cuda(x, a, h0),
                                    kernels=(plan.kernel,))
        k_ms = cuda_ms(lambda: rg_lru_cuda(x, a, h0), flush)
        p_ms = cuda_ms(lambda: rg_lru_plain(x, a, h0), flush, iters=3,
                       warmup=1)
        b_ms, b_by = bound_ms(b * s * cfg.d_model * 12 + b * cfg.d_model * 4,
                              2 * b * s * cfg.d_model, SCALAR_OPS_PER_S)
        if n_ops != 1 or plan.kernel != "rg_lru_ring":
            raise AssertionError(f"{tag}: B5 ran {n_ops} device ops per "
                                 f"call ({plan.kernel}), not one "
                                 f"rg_lru_ring")
        print(f"[{tag}] B5 on the path's (a, b) of the first RG-LRU block "
              f"(B={b} S={s} D={cfg.d_model} f32, h0 = 0): bit-equal to "
              f"its plain version | {plan.kernel} dt={plan.dt} st={plan.st}"
              f" ns={plan.ns} blocks={plan.blocks} | device us/call "
              f"{dev:.2f} (kernel {ker:.2f}) kernel_ms={k_ms:.4f} plain_ms="
              f"{p_ms:.4f} bound_ms={b_ms:.6f} ({b_by})")
        b5[tag] = {"device_us": dev, "kernel_us": ker, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "kernel": plan.kernel, "max_abs_err": 0.0, **nums}
        del captured, x, a, h0, want, have
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return launches, b5


def _oneshot_run(tag, model, params, batch, gen, kernels, want=None):
    """``greedy_generate`` of ``batch`` for ``gen`` tokens, counts of
    ``kernels`` set to 0 just before; the prefill and each decode step
    timed on the host clock (synchronized). Checks the tokens' shape and
    range, that the plan cache saw no lookup and, with ``want`` = (B3
    launches in the prefill, per decode step), B3's counts. Returns (tokens
    on the host, {kernel: launches}, {kernel: launches in the prefill},
    numbers)."""
    import torch
    from repro_torch.core import plancache
    from repro_torch.train.serve_step import greedy_generate
    prefill, decode = model.prefill, model.decode_step
    timing, steps, after_prefill = {}, [], {}

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(*a, **k)
        torch.cuda.synchronize()
        timing["prefill"] = time.perf_counter() - t
        after_prefill.update({k_.__name__: k_.launches for k_ in kernels})
        return out

    def timed_decode(*a, **k):
        t = time.perf_counter()
        out = decode(*a, **k)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t)
        return out
    b, s = batch["tokens"].shape
    cache = plancache.default_cache().stats()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    model.prefill, model.decode_step = timed_prefill, timed_decode
    try:
        toks = greedy_generate(model, params, batch, max_len=s + gen + 8,
                               n_steps=gen).cpu()
    finally:
        del model.prefill, model.decode_step
    got = {k.__name__: k.launches for k in kernels}
    after = plancache.default_cache().stats()
    decode_s = sum(steps)
    mid = sorted(steps)[len(steps) // 2]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{tag}] {model.cfg.quant.backend}: prefill "
          f"{timing['prefill']:.3f}s, decode {len(steps)} steps in "
          f"{decode_s:.3f}s -> {b * len(steps) / decode_s:.1f} tokens/s "
          f"(first step {steps[0] * 1e3:.1f} ms, median {mid * 1e3:.1f} ms, "
          f"host clock, synchronized a step) | {peak:.2f} GiB peak | "
          f"launches: {got}, in the prefill {after_prefill} | plan cache "
          f"hits+misses {cache['hits'] + cache['misses']} -> "
          f"{after['hits'] + after['misses']}")
    if tuple(toks.shape) != (b, gen) or not bool(
            ((toks >= 0) & (toks < model.cfg.vocab)).all()):
        raise AssertionError(f"{tag}: output malformed: {toks}")
    if (after["hits"], after["misses"]) != (cache["hits"], cache["misses"]):
        raise AssertionError(f"{tag}: the run touched the plan cache")
    if want is not None:
        pre, per = after_prefill["transitive_gemm_cuda"], \
            got["transitive_gemm_cuda"] - after_prefill["transitive_gemm_cuda"]
        if (pre, per) != (want[0], want[1] * (gen - 1)):
            raise AssertionError(
                f"{tag}: B3 launched {pre} times in the prefill and {per} "
                f"in {gen - 1} decode steps, not {want[0]} and {want[1]} a "
                f"step")
    numbers = {"prefill_s": timing["prefill"],
               "decode_tokens_per_s": b * len(steps) / decode_s,
               "decode_step_median_ms": mid * 1e3, "peak_gib": peak}
    return toks, got, after_prefill, numbers


def _oneshot_kernels():
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    return (transitive_gemm_cuda, transitive_forest, transitive_forest_dense,
            launch_sparse, paged_attention, rg_lru_cuda)


def _same_tokens(tag, toks, other, what):
    import torch
    same = int((other == toks).sum())
    print(f"[{tag}] {what}: tokens equal to the lut_cuda run: {same}/"
          f"{toks.numel()}")
    if not torch.equal(other, toks):
        raise AssertionError(f"{tag}: {what} tokens differ from lut_cuda's "
                             f"({same}/{toks.numel()} equal)")


def xlstm_path():
    """Phase 14: xlstm-125m at full width and depth (12 layers: 6 x
    (mlstm, slstm), d_model 768, 4 heads of 192, no MLP, vocab 50304 tied,
    bf16, W4A8 per-channel linears, random weights from seed 0 drawn on
    the card), served as the reference serves it: one-shot
    ``greedy_generate`` over dense caches (the paged engine refuses the
    config). (a) B = 4, 128-token prompts (two chunks of the chunkwise
    mLSTM), 32 tokens on ``lut_cuda``: B3 launches 6 x (5 + 8 x 128 + 1) =
    6,180 times in the prefill (the mLSTM's five linears, the sLSTM's
    eight a position and its ``w_out``) and 84 a decode step, B1, B2 and
    B5 not at all, the plan cache sees no lookup; then on ``engine_cuda``
    (every linear planned for B1 on the host and its ForestPlan attached,
    planning timed): B1 launches, B3 does not, the tokens are equal; then
    on ``int_dot``: equal. (b) B = 1, a 200-token prompt (one chunk of
    200: the reference's fallback where S is not a multiple of 64), 16
    tokens on ``lut_cuda`` (B3 6 x (6 + 8 x 200) in the prefill, 84 a
    step) and ``int_dot``: equal. Returns ({run: launches}, {run:
    numbers})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import oneshot_batch
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    cfg = serve_config(get_config("xlstm_125m"), backend="lut_cuda")
    model = Model(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, on_device=True)
    torch.cuda.synchronize()
    print(f"[phase 14] {cfg.name}: {cfg.n_layers} layers (full depth: "
          f"{cfg.n_repeats} x {cfg.block_pattern}), d_model={cfg.d_model} "
          f"heads={cfg.n_heads} hd={cfg.hd} d_ff={cfg.d_ff} vocab="
          f"{cfg.vocab} tied dtype={cfg.dtype} | paged path: "
          f"{model.supports_paged()} | init on the card "
          f"{time.perf_counter() - t0:.2f}s, "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB peak")
    kernels = _oneshot_kernels()
    per_step = cfg.n_repeats * (5 + 9)
    launches, numbers = {}, {}
    for run, (b, s, gen) in (("a", (4, 128, 32)), ("b", (1, 200, 16))):
        tag = f"phase 14 ({run}) B={b} S={s} -> {gen}"
        batch = oneshot_batch(model, b, s, s)
        want = (cfg.n_repeats * (5 + 8 * s + 1), per_step)
        toks, got, pre, nums = _oneshot_run(tag, model, params, batch, gen,
                                            kernels, want)
        if any(got[k.__name__] for k in kernels[1:]):
            raise AssertionError(f"{tag}: B1, B2 or B5 launched: {got}")
        launches[f"{tag}, lut_cuda"] = got
        numbers[tag] = nums
        if run == "a":
            from repro_torch.core import plancache
            from repro_torch.core.plancache import _iter_ptq_layers
            ecfg = cfg.replace(quant=cfg.quant.with_(backend="engine_cuda"))
            emodel = Model(ecfg, device="cuda")
            t0 = time.perf_counter()
            stats = emodel.precompile_plans(params)
            t_plan = time.perf_counter() - t0
            t0 = time.perf_counter()
            eparams = emodel.attach_device_plans(params)
            torch.cuda.synchronize()
            t_attach = time.perf_counter() - t0
            fbytes = sum(layer["dplan"].nbytes()
                         for layer in _iter_ptq_layers(eparams))
            print(f"[{tag}] engine_cuda planning on the host: "
                  f"{stats['plans']} plans over {stats['layers']} stacked "
                  f"linears in {t_plan:.2f}s, attach (lower, pack, upload) "
                  f"{t_attach:.2f}s | ForestPlans {fbytes} B on the card | "
                  f"{plancache.default_cache()!r}")
            etoks, egot, _, enums = _oneshot_run(tag, emodel, eparams, batch,
                                                 gen, kernels)
            if not egot["transitive_forest"] or any(
                    egot[k.__name__] for k in kernels if
                    k.__name__ != "transitive_forest"):
                raise AssertionError(f"{tag}: engine_cuda ran {egot}, not B1 "
                                     f"alone")
            _same_tokens(tag, toks, etoks, "engine_cuda (B1)")
            launches[f"{tag}, engine_cuda"] = egot
            numbers[tag]["engine_cuda"] = dict(
                enums, plan_s=t_plan, attach_s=t_attach, plans=stats["plans"])
            del eparams, emodel
        imodel = Model(cfg.replace(quant=cfg.quant.with_(backend="int_dot")),
                       device="cuda")
        itoks, igot, _, _ = _oneshot_run(tag, imodel, params, batch, gen,
                                         kernels)
        if any(igot.values()):
            raise AssertionError(f"{tag}: int_dot launched {igot}")
        _same_tokens(tag, toks, itoks, "int_dot (float64 integer GEMM)")
    del params
    torch.cuda.empty_cache()
    return launches, numbers


def cross_paths():
    """Phase 15: whisper-tiny at full width and depth (an encoder of 4
    non-causal attention layers with GELU MLPs over 1,500 seeded frame
    embeddings; 4 decoder layers of (attn, cross) with the GELU MLP after
    the cross block; d_model 384, 6 heads of 64, d_ff 1536, vocab 51865
    tied, its ``serve_config``: W4A8 linears, float attention, bf16
    caches). Phase 15b: llama-3.2-vision-90b at its published widths
    (d_model 8192, 64/8 heads, d_ff 28672, vocab 128256 untied, 1,024
    seeded patch embeddings) with one super-block, 4 attn + 1 cross of
    100 layers (90B parameters do not fit one card): W4A8, int8 attention,
    KV8 self caches, the cross cache bf16. Each: bf16, random weights from
    seed 0 drawn on the card, one-shot ``greedy_generate`` of B = 4
    128-token prompts -> 32 tokens with the launcher's seeded context
    (``launch.serve.oneshot_batch``) on ``lut_cuda``, B3 asserted (whisper
    64 in the prefill, 4 x 6 in the encoder and 4 x 10 in the decoder, 32
    a decode step; vision 35 and 33), B1, B2, B5 not launched, no plan
    cache lookup; then on ``int_dot``: every token equal. Returns ({run:
    launches}, {run: numbers})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import oneshot_batch
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    kernels = _oneshot_kernels()
    launches, numbers = {}, {}
    for arch, phase, n_layers, want in (
            ("whisper_tiny", "phase 15", None, (64, 32)),
            ("llama_3_2_vision_90b", "phase 15b", 5, (35, 33))):
        full = get_config(arch)
        cfg = serve_config(full, backend="lut_cuda")
        if n_layers is not None:
            cfg = cfg.replace(n_layers=n_layers)
        model = Model(cfg, device="cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(0, on_device=True)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        depth = (f"{cfg.n_layers} of {full.n_layers} layers (one super-"
                 f"block: 90B parameters do not fit one card)"
                 if n_layers else f"{cfg.n_layers} decoder layers (full "
                 f"depth) + {cfg.encoder_layers} encoder layers")
        print(f"[{phase}] {cfg.name}: {depth}, pattern {cfg.block_pattern} "
              f"mlp_after={cfg.mlp_after}, d_model={cfg.d_model} heads="
              f"{cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab} "
              f"{'tied' if cfg.tie_embeddings else 'untied'} context "
              f"{cfg.n_context_tokens} tokens | quant_attention="
              f"{cfg.quant_attention} kv_cache_bits={cfg.kv_cache_bits} | "
              f"paged path: {model.supports_paged()} | init on the card "
              f"{t_init:.2f}s, {init_peak:.2f} GiB peak")
        tag = f"{phase} B=4 S=128 -> 32"
        batch = oneshot_batch(model, 4, 128, 0)
        toks, got, _, nums = _oneshot_run(tag, model, params, batch, 32,
                                          kernels, want)
        if any(got[k.__name__] for k in kernels[1:]):
            raise AssertionError(f"{tag}: B1, B2 or B5 launched: {got}")
        imodel = Model(cfg.replace(quant=cfg.quant.with_(backend="int_dot")),
                       device="cuda")
        itoks, igot, _, _ = _oneshot_run(tag, imodel, params, batch, 32,
                                         kernels)
        if any(igot.values()):
            raise AssertionError(f"{tag}: int_dot launched {igot}")
        _same_tokens(tag, toks, itoks, "int_dot (float64 integer GEMM)")
        launches[f"{tag} ({cfg.name}), lut_cuda"] = got
        numbers[tag] = dict(nums, init_peak_gib=init_peak)
        del params, batch
        torch.cuda.empty_cache()
    return launches, numbers


def _train_kernels():
    """The kernels that mode-``none`` training must not launch (B1-B5 and
    B5's backward), for the counts of phases 16 and 16b."""
    from repro_torch.kernels.rg_lru import rg_lru_grad
    return _oneshot_kernels() + (rg_lru_grad,)


def train_path():
    """Phase 16: smollm-135m trained at full width and depth (30 layers,
    d_model 576, 9/3 heads, d_ff 1536, vocab 49152 tied, bf16, f32 AdamW
    moments, grad_accum 4, remat "block"; weights drawn on the card from
    seed 0) through ``train.loop.train`` at the reference launcher's
    defaults, global batch 32 of 512 tokens, lr 3e-4: (a) 8 steps
    straight; (b) the same job with ``ckpt_every=2`` and a failure
    injected at step 5 under ``run_with_restarts``: it resumes from the
    step-4 checkpoint, and its last loss must be within 2e-4 of (a)'s
    (the reference's bar). Mode ``none`` trains on plain products, as the
    reference trains on XLA dots: no B1-B5 launch over either run
    (counts set to 0 just before). Prints the step time (median of the
    three steps that :func:`_profile_train_step` times from (a)'s final
    state), tokens/s, the peak memory and the losses. Returns the
    numbers."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.fault import run_with_restarts
    from repro_torch.train.loop import train
    cfg = get_config("smollm_135m")
    if (cfg.n_layers, cfg.d_model, cfg.vocab, cfg.grad_accum, cfg.remat,
            cfg.dtype) != (30, 576, 49152, 4, "block", torch.bfloat16):
        raise AssertionError(f"phase 16: {cfg}")
    kernels = _train_kernels()
    kw = dict(seq_len=512, global_batch=32, steps=8, lr=3e-4, device="cuda")
    ckpt = os.path.join(ROOT, "build", "phase16_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    for k in kernels:
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, straight = train(cfg, **kw)
    t_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profiled = _profile_train_step("phase 16", cfg, state, kw, timed=3)
    mid = profiled["step_s_median"]
    del state
    torch.cuda.empty_cache()
    starts = []

    def job(attempt):
        _, hist = train(cfg, ckpt_dir=ckpt, ckpt_every=2,
                        fail_at_step=5 if attempt == 0 else None, **kw)
        starts.append(hist[0]["step"])
        return hist
    t0 = time.perf_counter()
    resumed, restarts = run_with_restarts(job, max_restarts=2)
    t_b = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    got = {k.__name__: k.launches for k in kernels}
    tokens = kw["global_batch"] * kw["seq_len"]
    losses = [round(h["loss"], 5) for h in straight]
    diff = abs(resumed[-1]["loss"] - straight[-1]["loss"])
    print(f"[phase 16] {cfg.name} trained at full width and depth: "
          f"{cfg.n_layers} layers d_model={cfg.d_model} vocab={cfg.vocab} "
          f"{cfg.dtype} grad_accum={cfg.grad_accum} remat={cfg.remat}, "
          f"batch {kw['global_batch']} x {kw['seq_len']} | (a) "
          f"{len(straight)} steps in {t_a:.1f}s, then a step "
          f"{mid:.4f}s (median of {len(profiled['step_s'])}) -> "
          f"{tokens / mid:.0f} tokens/s | peak {peak:.2f} GiB | losses "
          f"{losses} | (b) crashed at 5, {restarts} restart, resumed at "
          f"step {starts[-1]}: losses "
          f"{[round(h['loss'], 5) for h in resumed]} in {t_b:.1f}s | last "
          f"loss (a) {straight[-1]['loss']:.6f} (b) "
          f"{resumed[-1]['loss']:.6f}, |diff| {diff:.2e} (bar 2e-4) | "
          f"launches {got}")
    if restarts != 1 or starts != [4] or [h["step"] for h in resumed] != [
            4, 5, 6, 7]:
        raise AssertionError(f"phase 16: (b) did not resume at step 4: "
                             f"{restarts} restarts, starts {starts}")
    if diff > 2e-4 or not all(math.isfinite(h["loss"]) for h in straight):
        raise AssertionError(f"phase 16: resumed last loss off by {diff}")
    if straight[-1]["loss"] >= straight[0]["loss"]:
        raise AssertionError(f"phase 16: the loss did not fall: {losses}")
    if any(got.values()):
        raise AssertionError(f"phase 16: a kernel launched in mode none: "
                             f"{got}")
    return {"step_s_median": mid, "tokens_per_s": tokens / mid,
            "peak_gib": peak, "run_a_s": t_a,
            "losses": losses, "resumed_last_loss_diff": diff,
            "resumed_run_s": t_b, "profiled_step": profiled}


def _profile_train_step(tag, cfg, state, kw, timed, kernels=()):
    """More train steps from a run's final state: after a warm-up step,
    ``timed`` steps each on the host clock (ending with the loss read;
    their median is the step time), then one profiled
    (``launch/device_events.py``): device ms (every device op's self
    time), launches, the idle share 1 - device / host median, and, for
    each name in ``kernels``, that kernel's device ms and launches in the
    step."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.device_events import device_events
    from repro_torch.models.model import Model
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train.train_step import make_optimizer, make_train_step
    model = Model(cfg, device="cuda")
    step_fn = make_train_step(model, make_optimizer(cfg),
                              cosine_schedule(kw["lr"], 2, kw["steps"]))
    batch = SyntheticLM(cfg, kw["seq_len"], kw["global_batch"],
                        device="cuda").batch(kw["steps"], cfg.grad_accum)

    def one():
        return float(step_fn(state, batch)[1]["loss"])
    one()
    times = []
    for _ in range(timed):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    mid = sorted(times)[len(times) // 2]
    host = mid * 1e3
    events = device_events(one)
    dev = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    named = {k: {"device_ms": sum(e.self_device_time_total for e in events
                                  if k in e.key) / 1e3,
                 "launches": sum(e.count for e in events if k in e.key)}
             for k in kernels}
    print(f"[{tag}] {timed} train steps: "
          f"{', '.join(f'{t:.4f}s' for t in times)}; one profiled: host "
          f"{host:.2f} ms (median), device {dev:.3f} ms, idle "
          f"{1 - dev / host:.3f}, {launches} launches; "
          + "".join(f"{k} {v['device_ms']:.3f} ms x{v['launches']}; "
                    for k, v in named.items())
          + "top: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))
    return {"step_s": times, "step_s_median": mid, "host_ms": host,
            "device_ms": dev, "idle": 1 - dev / host, "launches": launches,
            "kernels": named}


def _rg_lru_grad_check(flush):
    """B5's backward (``rg_lru_grad``: the kernel over time reversed) at
    recurrentgemma-9b's path shapes, B=4 S=128 and B=1 S=2100, D=4096,
    f32, against autograd through the plain version on the same (x, a,
    h0, dh): dx, da, dh0 within atol 1e-5 x max |want| (the same f32
    products and sums; the tolerance covers another order of the
    elementwise tail). Times: the function's call (kernel ms, L2 flushed),
    the profiler's device us (every op, and the kernel alone), autograd
    through the plain version, and the bytes bound (dh, a, h read once;
    dx, da written once; h0, dh0). Returns the entries by shape."""
    import torch
    from repro_torch.kernels.rg_lru import (launch_plan, rg_lru_cuda,
                                            rg_lru_grad, rg_lru_plain)
    gen = torch.Generator(device="cuda").manual_seed(17)
    out = []
    for b, s in ((4, 128), (1, 2100)):
        d = 4096
        x = torch.randn((b, s, d), generator=gen, device="cuda")
        a = torch.rand((b, s, d), generator=gen, device="cuda") * 0.199 + 0.8
        h0 = torch.randn((b, d), generator=gen, device="cuda")
        dh = torch.randn((b, s, d), generator=gen, device="cuda")
        h = rg_lru_cuda(x, a, h0)
        before = rg_lru_grad.launches
        dx, da, dh0 = rg_lru_grad(dh, a, h, h0)
        if rg_lru_grad.launches != before + 1:
            raise AssertionError("B5 grad: one launch a call expected")
        args = [t.clone().requires_grad_(True) for t in (x, a, h0)]
        want = torch.autograd.grad(rg_lru_plain(*args), args, dh)
        torch.cuda.synchronize()
        errs, bits = [], True
        for name, g, w in zip(("dx", "da", "dh0"), (dx, da, dh0), want):
            err = float((g - w).abs().max())
            errs.append(err)
            bits &= torch.equal(g, w)
            if g.dtype != w.dtype or err > 1e-5 * float(w.abs().max()):
                raise AssertionError(f"B5 grad B={b} S={s}: {name} off by "
                                     f"{err} (max |want| "
                                     f"{float(w.abs().max())})")
        plan = launch_plan(b, s, d, 4, 4, 4, 0, 0, 0)
        dev, ker, n_ops = device_us(lambda: rg_lru_grad(dh, a, h, h0),
                                    kernels=(plan.kernel,))
        k_ms = cuda_ms(lambda: rg_lru_grad(dh, a, h, h0), flush)

        def plain():
            ins = [t.clone().requires_grad_(True) for t in (x, a, h0)]
            torch.autograd.grad(rg_lru_plain(*ins), ins, dh)
        p_ms = cuda_ms(plain, flush, iters=2, warmup=1)
        n_bytes = 5 * b * s * d * 4 + 2 * b * d * 4
        b_ms, b_by = bound_ms(n_bytes, 3 * b * s * d, SCALAR_OPS_PER_S)
        shape = f"B={b} S={s} D={d} f32"
        print(f"[B5 grad] {shape}: dx, da, dh0 max |diff| "
              f"{', '.join(f'{e:.3g}' for e in errs)} against autograd "
              f"through the plain version (atol 1e-5 x max |want|; "
              f"bit-equal: {bits}) | {plan.kernel} | kernel_ms={k_ms:.4f} "
              f"plain_ms={p_ms:.4f} library_ms=null bound_ms={b_ms:.6f} "
              f"({b_by}) | device us/call {dev:.2f} (kernel {ker:.2f}, "
              f"{n_ops:g} ops)")
        out.append({"shape": shape, "kernel": plan.kernel, "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                    "bound_by": b_by, "device_us": dev, "kernel_us": ker,
                    "device_ops": n_ops, "max_abs_err": max(errs),
                    "bit_equal": bool(bits), "tolerance": "atol 1e-5 x "
                    "max |autograd through the plain version|"})
        del x, a, h0, dh, h, dx, da, dh0, want, args
        torch.cuda.empty_cache()
    return out


def train_recurrent_path(flush):
    """Phase 16b: recurrentgemma-9b at its published widths (d_model 4096,
    16 heads over 1 KV head, hd 256, d_ff 12288, vocab 256000 tied, bf16,
    remat "block") with one super-block plus the tail, (rglru, rglru,
    attn) + (rglru, rglru): 5 of 38 layers, since a 9B model with AdamW
    state does not fit one card. Two train steps through
    ``train.loop.train`` at seq 256, global batch 8, grad_accum 8: the
    RG-LRU's recurrence runs on B5 forward and backward (counts set to 0
    just before): per microbatch 4 forward launches, 2 more where remat
    recomputes the super-block, and 4 backward. Then three more steps
    from the final state, timed, and one profiled
    (:func:`_profile_train_step`: B5's device time in the step, forward
    and backward together, as both run one kernel), and B5's forward and
    backward apart at the step's shape (:func:`_rg_lru_step_calls`).
    Then B5's gradient at the serving path's shapes against autograd
    through its plain version (:func:`_rg_lru_grad_check`). Returns
    (launches, numbers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rg_lru import launch_plan
    from repro_torch.optim.adamw import leaves
    from repro_torch.train.loop import train
    cfg = get_config("recurrentgemma_9b").replace(n_layers=5)
    kinds = cfg.block_pattern * cfg.n_repeats + cfg.block_tail
    if (kinds, cfg.d_model, cfg.grad_accum, cfg.remat) != (
            ("rglru", "rglru", "attn", "rglru", "rglru"), 4096, 8, "block"):
        raise AssertionError(f"phase 16b: {kinds} {cfg}")
    kernels = _train_kernels()
    for k in kernels:
        k.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(seq_len=256, global_batch=8, steps=2, lr=3e-4, device="cuda")
    t0 = time.perf_counter()
    state, hist = train(cfg, **kw)
    t_run = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    got = {k.__name__: k.launches for k in kernels}
    n_params = sum(t.numel() for t in leaves(state["params"]))
    mb = kw["global_batch"] // cfg.grad_accum
    b5 = launch_plan(mb, kw["seq_len"], cfg.d_model, 4, 4, 4).kernel
    profiled = _profile_train_step("phase 16b", cfg, state, kw, timed=3,
                                   kernels=(b5,))
    del state
    torch.cuda.empty_cache()
    body = cfg.block_pattern.count("rglru") * cfg.n_repeats
    n_rglru = body + cfg.block_tail.count("rglru")
    micro = kw["steps"] * cfg.grad_accum
    want_fwd, want_bwd = micro * (n_rglru + body), micro * n_rglru
    print(f"[phase 16b] {cfg.name} at published widths, 5 of 38 layers "
          f"({kinds}; the full depth with AdamW state does not fit one "
          f"card), {n_params / 1e9:.3f}B params, bf16, f32 moments, seq "
          f"256, batch 8, grad_accum 8, remat {cfg.remat} | 2 steps in "
          f"{t_run:.1f}s, losses "
          f"{[round(h['loss'], 5) for h in hist]}, grad_norm "
          f"{[round(h['grad_norm'], 4) for h in hist]} | peak {peak:.2f} "
          f"GiB | B5 forward {got['rg_lru_cuda']} (want {want_fwd}), "
          f"backward {got['rg_lru_grad']} (want {want_bwd}) | launches "
          f"{got}")
    if (got["rg_lru_cuda"], got["rg_lru_grad"]) != (want_fwd, want_bwd):
        raise AssertionError(f"phase 16b: B5 forward/backward launches "
                             f"{got['rg_lru_cuda']}/{got['rg_lru_grad']}, "
                             f"not {want_fwd}/{want_bwd}")
    if any(v for k, v in got.items() if k not in ("rg_lru_cuda",
                                                  "rg_lru_grad")):
        raise AssertionError(f"phase 16b: B1-B4 launched: {got}")
    in_step = profiled["kernels"][b5]["launches"]
    if in_step != (want_fwd + want_bwd) // kw["steps"]:
        raise AssertionError(f"phase 16b: the profiled step ran {b5} "
                             f"{in_step} times, not "
                             f"{(want_fwd + want_bwd) // kw['steps']}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in hist):
        raise AssertionError(f"phase 16b: non-finite or zero: {hist}")
    launches = {"phase 16b forward": got["rg_lru_cuda"],
                "phase 16b backward": got["rg_lru_grad"]}
    calls = _rg_lru_step_calls(mb, kw["seq_len"], cfg.d_model, b5)
    grads = _rg_lru_grad_check(flush)
    return launches, {"phase_16b": {"run_s": t_run, "peak_gib": peak,
                                    "params": n_params,
                                    "profiled_step": profiled,
                                    "b5_calls": calls},
                      "grad": grads}


def _rg_lru_step_calls(b, s, d, kernel):
    """B5's forward (``rg_lru_cuda``) and backward (``rg_lru_grad``) calls
    at one microbatch's shape in phase 16b's step (x, a, dh (b, s, d)
    f32, h0 zero), apart: device us a call of the whole function and of
    ``kernel`` alone, from ``torch.profiler``. The launches that this
    makes are left out of every count (the counts were read before)."""
    import torch
    from repro_torch.kernels.rg_lru import rg_lru_cuda, rg_lru_grad
    gen = torch.Generator(device="cuda").manual_seed(18)
    x = torch.randn((b, s, d), generator=gen, device="cuda")
    a = torch.rand((b, s, d), generator=gen, device="cuda") * 0.199 + 0.8
    dh = torch.randn((b, s, d), generator=gen, device="cuda")
    h0 = torch.zeros((b, d), device="cuda")
    h = rg_lru_cuda(x, a, h0)
    out = {}
    for name, fn in (("forward", lambda: rg_lru_cuda(x, a, h0)),
                     ("backward", lambda: rg_lru_grad(dh, a, h, h0))):
        dev, ker, n_ops = device_us(fn, kernels=(kernel,))
        out[name] = {"device_us": dev, "kernel_us": ker, "ops": n_ops}
    print(f"[phase 16b] B5 at the step's shape B={b} S={s} D={d} f32, a "
          f"call: " + "; ".join(
              f"{k} {v['device_us']:.2f} us ({kernel} {v['kernel_us']:.2f} "
              f"us, {v['ops']:g} ops)" for k, v in out.items()))
    return out


def accuracy_path():
    """Phase 17: the accuracy example (``repro_torch.examples.
    quantize_eval``) on the card: reduced smollm (2 layers, f32) trained
    60 steps at lr 5e-3 (the loss must fall by more than 0.5, the mean of
    the last 3 against the first 3: the reference's bar), then the
    perplexity of a held-out batch under fp32, and W8A8 and W4A8 (group
    64) on ``int_dot``, ``lut_cuda`` (B3) and ``engine_cuda`` (B1, plans
    built on the host): the three give the same int32 accumulators, so
    the transitive perplexities must equal int_dot's bit for bit. B3 and
    B1 must launch (counts set to 0 just before). Returns (launches,
    numbers)."""
    from repro_torch.examples import quantize_eval
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    kernels = _train_kernels()
    for k in kernels:
        k.launches = 0
    lines = []
    out = quantize_eval.evaluate("cuda", log=lines.append)
    got = {k.__name__: k.launches for k in kernels}
    for line in lines:
        print(f"[phase 17] {line}")
    hist = out["hist"]
    first = sum(h["loss"] for h in hist[:3]) / 3
    last = sum(h["loss"] for h in hist[-3:]) / 3
    print(f"[phase 17] loss {first:.4f} -> {last:.4f} (mean of the first "
          f"and last 3 of {len(hist)} steps; bar: a fall > 0.5) | "
          f"launches {got}")
    if not last < first - 0.5:
        raise AssertionError(f"phase 17: the loss fell {first - last}")
    for bits in ("W8A8", "W4A8"):
        res = out[bits]
        if set(res) != {"int_dot", "lut_cuda", "engine_cuda"} or len(
                set(res.values())) != 1:
            raise AssertionError(f"phase 17: {bits} perplexities differ: "
                                 f"{res}")
    if not (got[transitive_gemm_cuda.__name__]
            and got[transitive_forest.__name__]):
        raise AssertionError(f"phase 17: B3 or B1 did not launch: {got}")
    if any(v for k, v in got.items() if k not in (
            transitive_gemm_cuda.__name__, transitive_forest.__name__)):
        raise AssertionError(f"phase 17: another kernel launched: {got}")
    return got, {"loss_first3": first, "loss_last3": last,
                 "ppl": {k: out[k] for k in ("fp32", "W8A8", "W4A8")}}


def _counts(kernels):
    return {k.__name__: k.launches for k in kernels}


def _zero(kernels):
    for k in kernels:
        k.launches = 0


PAPER_BANDS = {"ant": (3.4, 6.5), "olive": (5.2, 9.5), "bitvert": (2.6, 5.2)}


def paper_path():
    """Phase 19: the paper's evaluation and the launcher flags.

    (a) ``examples.quickstart.main()`` on the card: step 4 is one B3
    launch (64 x 64 int4 weights, M = 32, T = 8), bit-equal to the int64
    GEMM and to ``transitive_gemm_plain`` on the same operands. (b)
    ``examples.serve_lm.main()`` on the card (reduced chatglm3-6b, f32 and
    W4A8 on ``int_dot``, 4 x 16 -> 8; its lossless check on ``lut_cuda``),
    then the example's W4A8 model and params once more on ``lut_cuda``:
    every token equal to the ``int_dot`` run's, B3 launched. (c)
    ``paper.run`` with its six sections, the rows printed; the Fig. 10
    llama1-7b TA4 ratios within the reference's bands
    (``tests/test_costmodel.py``). (d) ``launch.serve.main`` on
    smollm-135m at full width and depth, ``--continuous --paged-kernel``
    with phase 5's sizes (8 requests of 128-token prompts sharing
    prefixes, 32 tokens, 4 slots, page_size 16; one arrival a host step),
    its weights drawn on the card from seed 0: on ``lut_cuda`` bucketed,
    again with ``--no-bucket-prefill`` (tokens equal), and ``--path
    engine_cuda --no-precompile`` on a fresh plan cache (the
    ``DeprecationWarning`` caught; no precompile, all 210 plans built
    inside attach, none while serving; tokens equal to the lut_cuda
    run's, the two backends' int32 accumulators being equal). (e) a
    greedy loop over ``make_prefill`` / ``make_decode_step`` on
    smollm-135m at full width on ``lut_cuda`` (B = 4 x 16 -> 16): tokens
    equal to ``greedy_generate``'s. Counts are set to 0 just before each
    run. Returns ({run: {kernel: launches}}, numbers)."""
    import contextlib
    import io
    import warnings

    import numpy as np
    import torch
    from repro_torch.analysis import programs
    from repro_torch.configs import get_config
    from repro_torch.core import plancache
    from repro_torch.examples import quickstart, serve_lm
    from repro_torch.kernels.transitive_gemm import transitive_gemm_plain
    from repro_torch.launch import serve
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    from repro_torch.paper import run as paper_run
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill)
    kernels = _oneshot_kernels()
    b3 = "transitive_gemm_cuda"
    launches, numbers = {}, {}
    lint_backend = programs.lint_backend

    def only(tag, got, *names):
        if not all(got[n] for n in names) or any(
                v for k, v in got.items() if k not in names):
            raise AssertionError(f"{tag}: launches {got}, expected only "
                                 f"{names}")

    # -- (a) quickstart ------------------------------------------------------
    _zero(kernels)
    t0 = time.perf_counter()
    q = quickstart.main()
    dt = time.perf_counter() - t0
    got = launches["phase 19a (quickstart)"] = _counts(kernels)
    want = (q["w"].astype(np.int64) @ q["x"].astype(np.int64)).T
    qx = torch.as_tensor(q["x"].T, dtype=torch.int8, device="cuda")
    qw = torch.as_tensor(q["w"], dtype=torch.int8, device="cuda")
    plain = transitive_gemm_plain(qx, qw, w_bits=4, t=8)[:, 0].cpu()
    err = int((q["out_kernel"].long() - torch.from_numpy(want)).abs().max())
    print(f"[phase 19a] quickstart on the card in {dt:.2f}s: density "
          f"{q['density']:.4f}, patterns {q['patterns']} | B3 (M=32 N=64 "
          f"K=64 w_bits 4 T=8) max |err| against the int64 GEMM {err}, "
          f"equal to its plain version: "
          f"{torch.equal(q['out_kernel'], plain)} | launches {got}")
    if got[b3] != 1 or err or not torch.equal(q["out_kernel"], plain):
        raise AssertionError(f"phase 19a: B3 launched {got[b3]} times, "
                             f"max |err| {err}")
    only("phase 19a", got, b3)

    # -- (b) serve_lm ----------------------------------------------------------
    _zero(kernels)
    t0 = time.perf_counter()
    ex = serve_lm.main()
    dt = time.perf_counter() - t0
    got = launches["phase 19b (serve_lm)"] = _counts(kernels)
    only("phase 19b (serve_lm)", got, b3)       # its lossless check
    mq = ex["model_q"]
    lcfg = mq.cfg.replace(quant=mq.cfg.quant.with_(backend="lut_cuda"))
    _zero(kernels)
    toks = greedy_generate(Model(lcfg, device="cuda"), ex["params_q"],
                           ex["batch"], max_len=64, n_steps=8).cpu()
    got = launches["phase 19b (serve_lm W4A8 on lut_cuda)"] = \
        _counts(kernels)
    same = int((toks == ex["tokens_q"]).sum())
    print(f"[phase 19b] serve_lm on the card in {dt:.2f}s ({lcfg.name}, "
          f"{lcfg.n_layers} layers, f32 and W4A8 on int_dot) | its W4A8 "
          f"model on lut_cuda: tokens equal to int_dot's {same}/"
          f"{toks.numel()} | launches {got}")
    if not torch.equal(toks, ex["tokens_q"]):
        raise AssertionError(f"phase 19b: lut_cuda tokens differ from "
                             f"int_dot's ({same}/{toks.numel()} equal)")
    only("phase 19b (lut_cuda)", got, b3)

    # -- (c) the paper's sections -----------------------------------------------
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        paper_run.main([])
    numbers["paper_run_s"] = time.perf_counter() - t0
    rows = buf.getvalue().splitlines()
    for row in rows:
        print(f"[phase 19c] {row}")
    fig10 = next(r for r in rows if r.startswith("fig10_fc_llama1-7b,"))
    ratios = {part.split(":")[0]: float(part.split(":x")[1].split("/")[0])
              for part in fig10.split(",", 2)[2].split()}
    numbers["fig10_llama1_7b_ta4_speedup"] = ratios
    print(f"[phase 19c] {len(rows)} rows in {numbers['paper_run_s']:.2f}s "
          f"(the modelled accelerators' numbers, computed on the host) | "
          f"Fig. 10 llama1-7b TA4 speedups {ratios}, bands {PAPER_BANDS}")
    for name, (lo, hi) in PAPER_BANDS.items():
        if not lo < ratios[name] < hi:
            raise AssertionError(f"phase 19c: TA4 over {name} "
                                 f"x{ratios[name]} outside ({lo}, {hi})")

    # -- (d) the launcher's flags at full width ---------------------------------
    argv = ["--arch", "smollm-135m", "--continuous", "--paged-kernel",
            "--requests", "8", "--prompt-len", "128", "--gen", "32",
            "--slots", "4", "--page-size", "16", "--arrive-every", "0"]
    served = {}
    runs = (("lut_cuda", ["--backend", "lut_cuda"]),
            ("lut_cuda --no-bucket-prefill",
             ["--backend", "lut_cuda", "--no-bucket-prefill"]),
            ("--path engine_cuda --no-precompile --lint",
             ["--path", "engine_cuda", "--no-precompile", "--lint"]))
    for run, extra in runs:
        tag = f"phase 19d ({run})"
        cache = plancache.PlanCache()
        prev = plancache.set_default_cache(cache)
        attach, precompile = plancache.attach_device_plans, \
            plancache.precompile
        built = {"attach": 0, "precompile": 0}

        def counted_attach(*a, **k):
            m0 = cache.stats()["misses"]
            out = attach(*a, **k)
            built["attach"] += cache.stats()["misses"] - m0
            return out

        def counted_precompile(*a, **k):
            # the serving path's precompiles (the --lint preflight's
            # programs plan in a cache of their own)
            if (a[2] if len(a) > 2 else k.get("cache")) in (None, cache):
                built["precompile"] += 1
            return precompile(*a, **k)

        preflight = []

        def recorded_lint_backend(*a, **k):
            t = time.perf_counter()
            progs, found = lint_backend(*a, **k)
            preflight.append((progs, found, time.perf_counter() - t))
            return progs, found
        plancache.attach_device_plans = counted_attach
        plancache.precompile = counted_precompile
        programs.lint_backend = recorded_lint_backend
        _zero(kernels)
        t0 = time.perf_counter()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                eng = serve.main(argv + extra)
            torch.cuda.synchronize()
        finally:
            plancache.attach_device_plans = attach
            plancache.precompile = precompile
            programs.lint_backend = lint_backend
            plancache.set_default_cache(prev)
        dt = time.perf_counter() - t0
        got = launches[tag] = _counts(kernels)
        served[run] = {r.rid: r.tokens for r in eng.finished}
        misses = cache.stats()["misses"]
        deprecated = [str(w.message) for w in caught
                      if issubclass(w.category, DeprecationWarning)]
        c = eng.report()["counters"]
        print(f"[{tag}] {dt:.2f}s (weights drawn on the card, serve, "
              f"planning where planned) | bucket_prefill="
              f"{eng.bucket_prefill} batched prefills "
              f"{c['prefill_batched_calls']} single {c['prefill_calls']} | "
              f"plan cache misses {misses}, built inside attach "
              f"{built['attach']}, precompile calls {built['precompile']} | "
              f"DeprecationWarnings {deprecated} | launches {got}")
        numbers[tag] = {"s": dt, "plans_built_in_attach": built["attach"]}
        if sorted(map(len, served[run].values())) != [32] * 8:
            raise AssertionError(f"{tag}: output malformed")
        counted = _gates().take(tag)
        if "engine_cuda" in run:
            lint, pub = (_gate(counted, w) for w in ("lint_plans",
                                                     "cache-publish"))
            print(f"[{tag}] --lint preflight: {lint['artifacts']} "
                  f"artifacts verified, {lint['findings']} findings, "
                  f"{lint['s']:.2f}s | cache-publish {pub['artifacts']} "
                  f"plans, {pub['findings']} findings, {pub['s']:.2f}s")
            numbers[tag]["plan_verifier"] = counted
            if not lint["artifacts"] or lint["findings"] or \
                    pub["artifacts"] != 210 or pub["findings"]:
                raise AssertionError(f"{tag}: the plan verifier counted "
                                     f"{counted}")
            if len(preflight) != 1:
                raise AssertionError(f"{tag}: {len(preflight)} tracelint "
                                     f"preflights")
            progs, found, pre_s = preflight[0]
            built_progs = [p.name for p in progs if not p.skipped]
            print(f"[{tag}] --lint tracelint preflight: "
                  f"{len(built_progs)} programs on cuda "
                  f"({', '.join(built_progs)}), {len(found)} findings, "
                  f"{pre_s:.2f}s (its plans in a cache of its own: "
                  f"{_gate(counted, 'tracelint')})")
            numbers[tag]["tracelint_preflight"] = {
                "programs": built_progs, "findings": len(found),
                "s": pre_s}
            if found or len(built_progs) != 7:
                raise AssertionError(f"{tag}: the tracelint preflight "
                                     f"built {built_progs}, findings "
                                     f"{[f.format() for f in found]}")
            if (misses, built["attach"], built["precompile"]) != (210, 210,
                                                                  0):
                raise AssertionError(
                    f"{tag}: {misses} misses, {built['attach']} built in "
                    f"attach, {built['precompile']} precompiles; expected "
                    f"210, 210, 0")
            if not any("--path is deprecated" in m for m in deprecated):
                raise AssertionError(f"{tag}: no DeprecationWarning")
            only(tag, got, "transitive_forest", "paged_attention")
        else:
            if eng.bucket_prefill == ("--no-bucket" in run) or misses:
                raise AssertionError(f"{tag}: bucket_prefill "
                                     f"{eng.bucket_prefill}, {misses} plans")
            only(tag, got, b3, "paged_attention")
        if served[run] != served["lut_cuda"]:
            same = sum(a == b for rid, ts in served[run].items()
                       for a, b in zip(ts, served["lut_cuda"][rid]))
            raise AssertionError(f"{tag}: tokens differ from the bucketed "
                                 f"lut_cuda run's ({same}/256 equal)")
        print(f"[{tag}] tokens equal to the bucketed lut_cuda run's: "
              f"256/256")
        del eng

    # -- (e) make_prefill / make_decode_step ----------------------------------
    cfg = serve_config(get_config("smollm_135m"), backend="lut_cuda")
    model = Model(cfg, device="cuda")
    params = model.init(0, on_device=True)
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab, size=(4, 16)))
    max_len, gen = 16 + 16 + 8, 16
    prefill, step = make_prefill(model, max_len), make_decode_step(model)
    _zero(kernels)
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": tokens})
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        logits, caches = step(params, caches, tok, 16 + i)
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        out.append(tok)
    loop = torch.cat(out, dim=1).cpu()
    dt = time.perf_counter() - t0
    got = launches["phase 19e (make_prefill / make_decode_step)"] = \
        _counts(kernels)
    want = greedy_generate(model, params, {"tokens": tokens}, max_len,
                           gen).cpu()
    same = int((loop == want).sum())
    print(f"[phase 19e] {cfg.name} full width on lut_cuda, B=4 S=16 -> "
          f"{gen}: the factories' loop in {dt:.3f}s, tokens equal to "
          f"greedy_generate's {same}/{want.numel()} | launches {got}")
    if not torch.equal(loop, want):
        raise AssertionError(f"phase 19e: {same}/{want.numel()} equal")
    only("phase 19e", got, b3)
    return launches, numbers


def _leaf_fault(fplan):
    """A host copy of an unstacked ForestPlan's producer with its first
    gathered node that no other node is made from set to FOREST_UNUSED:
    (producer, tile, node, the outputs that gather the node)."""
    import numpy as np
    from repro_torch.core.engine import FOREST_UNUSED
    prod = fplan.producer.cpu().numpy().copy()
    rows = fplan.rows.cpu().numpy().astype(np.int64)
    for j in range(prod.shape[0]):
        p = prod[j].astype(np.int64)
        chained = np.flatnonzero(p < fplan.t)
        prefixes = set((chained ^ (1 << p[chained])).tolist())
        for v in np.unique(rows[j]):
            if v and int(v) not in prefixes:
                prod[j, v] = FOREST_UNUSED
                readers = int((rows[j] == v).any(0).sum())
                return prod, j, int(v), readers
    raise AssertionError("phase 20: no gathered leaf node")


def _replace_layer(tree, parts, fn):
    """A copy of ``tree`` with the layer dict at ``parts`` replaced by
    ``fn(layer)`` (the rest shared)."""
    if not parts:
        return fn(tree)
    return {**tree, parts[0]: _replace_layer(tree[parts[0]], parts[1:], fn)}


def verifier_path():
    """Phase 20: the plan verifier on the card.

    (a) ``lint_plans(["engine_torch", "engine_cuda"])`` on ``cuda``: zero
    findings, the artifact labels printed. (b) smollm-135m with one layer
    at full width on ``engine_cuda``: the up projection's (1536 x 576,
    T = 8) unstacked ForestPlan, built through a plan cache (both publish
    gates), on the card; a copy with one gathered node's producer byte
    set to FOREST_UNUSED (dtype, contiguity and device sound: the
    ForestPlan's own checks pass it) runs through B1
    (``transitive_forest_rows``) and differs from the exact integer GEMM,
    which the clean plan equals; that copy, and a copy with two gathered
    nodes swapped, are each refused at ``cache-lowering`` (a compile hook
    that returns them); a generation carrying the first copy (in the
    layer's stacked plan) is refused at ``swap-staging``: nothing staged,
    and the engine serves on with its tokens unchanged. (c) The model's 7
    plans written as bundles, one file truncated: ``load_bundles``
    refuses at ``bundle-load`` with ``bundle-file`` and the wrapped
    ``bundles._sha256`` never reads the file. Every part raises on
    failure. Returns ({run: {kernel: launches}}, numbers)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch
    from repro_torch.analysis.planlint import (PlanVerificationError,
                                               lint_plans)
    from repro_torch.configs import get_config
    from repro_torch.core import plancache
    from repro_torch.core.backend import EngineConfig, get_backend
    from repro_torch.core.engine import ForestPlan
    from repro_torch.fleet import bundles, load_bundles, write_bundles
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import (transitive_forest,
                                                       transitive_forest_rows)
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine
    kernels = (transitive_forest, paged_attention)
    for k in kernels:
        k.launches = 0
    numbers = {}

    # -- (a) lint_plans on the card -----------------------------------------
    t0 = time.perf_counter()
    report, findings = lint_plans(["engine_torch", "engine_cuda"])
    numbers["lint_plans_s"] = time.perf_counter() - t0
    for row in report:
        print(f"[phase 20a] lint_plans {row['backend']} on cuda: artifacts "
              f"{row['artifacts']}, findings {len(row['findings'])}")
    print(f"[phase 20a] {len(findings)} findings in "
          f"{numbers['lint_plans_s']:.2f}s")
    if findings or not all(row["artifacts"] for row in report):
        raise AssertionError(f"phase 20a: {[f.format() for f in findings]}")
    _gates().take("phase 20a (lint_plans)")

    # -- (b) a corrupted ForestPlan: B1 is silently wrong, the gates refuse --
    cfg = serve_config(get_config("smollm_135m").replace(n_layers=1),
                       backend="engine_cuda").replace(paged_kernel=True)
    model = Model(cfg, device="cuda")
    raw = model.init(0)
    lpath, layer = next((p, lay) for p, lay in bundles._iter_layer_paths(raw)
                        if tuple(lay["qw"].shape[-2:]) == (1536, 576))
    qw = layer["qw"][0]
    ecfg = EngineConfig(w_bits=cfg.quant.w_bits, t=cfg.quant.transrow_t,
                        groups=plancache._layer_groups(layer["sg"]))
    cache = plancache.PlanCache()
    fplan = cache.get_or_build_device(qw, ecfg, backend="engine_cuda",
                                      device="cuda")
    if not isinstance(fplan, ForestPlan) or fplan.lead or fplan.t != 8 \
            or fplan.producer.device.type != "cuda":
        raise AssertionError(f"phase 20b: {type(fplan).__name__} "
                             f"t={fplan.t} lead {fplan.lead}")
    prod, j, v, readers = _leaf_fault(fplan)
    bad = dataclasses.replace(fplan, producer=torch.from_numpy(prod).cuda())
    rows = fplan.rows.cpu().numpy().copy()
    s_, n1 = (int(i) for i in np.argwhere(rows[j] != 0)[0])
    n2 = int(np.flatnonzero(rows[j, s_] != rows[j, s_, n1])[0])
    rows[j, s_, [n1, n2]] = rows[j, s_, [n2, n1]]
    swapped = dataclasses.replace(fplan, rows=torch.from_numpy(rows).cuda())
    gen = torch.Generator(device="cuda").manual_seed(20)
    qx = torch.randint(-128, 128, (64, 576), generator=gen, device="cuda",
                       dtype=torch.int8)
    exact = (qx.double() @ qw.double().T).to(torch.int32)
    good_out = transitive_forest_rows(fplan, qx)
    bad_out = transitive_forest_rows(bad, qx)
    torch.cuda.synchronize()
    wrong = int((bad_out != exact).sum())
    print(f"[phase 20b] {lpath} (1536 x 576, T=8) ForestPlan on the card: "
          f"B1 equals the exact GEMM: {torch.equal(good_out, exact)} | the "
          f"copy with tile {j} node {v} (gathered by {readers} outputs) set "
          f"FOREST_UNUSED (a ForestPlan whose dtype, contiguity and device "
          f"hold): B1 differs from the exact GEMM in {wrong} of "
          f"{exact.numel()} outputs, max |diff| "
          f"{int((bad_out.long() - exact.long()).abs().max())}")
    if not torch.equal(good_out, exact) or not wrong:
        raise AssertionError(f"phase 20b: clean plan exact "
                             f"{torch.equal(good_out, exact)}, corrupted "
                             f"plan wrong in {wrong} outputs")
    b = get_backend("engine_cuda")
    real = type(b).compile
    refusals = {}
    for name, copy, rules in (
            ("unused node", bad, ("forest-gathers", "forest-producers")),
            ("swapped gathers", swapped, ("plan-forest-agreement",))):
        fresh = plancache.PlanCache()
        type(b).compile = lambda self, plan, device=None, _c=copy: _c
        try:
            fresh.get_or_build_device(qw, ecfg, backend="engine_cuda",
                                      device="cuda")
        except PlanVerificationError as e:
            f = e.findings[0]
            refusals[name] = f"{e.where}: {f.rule} at {f.path}"
            if e.where != "cache-lowering" or f.rule not in rules or any(
                    entry.device for entry in fresh._plans.values()):
                raise AssertionError(f"phase 20b: {name}: {e}")
        else:
            raise AssertionError(f"phase 20b: the {name} copy was memoized")
        finally:
            type(b).compile = real
    print(f"[phase 20b] refused at cache-lowering: {refusals}")
    params0 = model.attach_device_plans(raw)
    eng = ServeEngine(model, params0, n_slots=4, max_len=256, page_size=16,
                      paged_kernel=True, device="cuda")
    prompts = _prompts(cfg.vocab, 4, 64)

    def serve_round():
        rids = [eng.submit(p, 16) for p in prompts]
        eng.run()
        done = {r.rid: r.tokens for r in eng.finished}
        return [done[r] for r in rids]
    before = serve_round()

    def corrupt(lay):
        d = lay["dplan"]
        if not torch.equal(d.producer[0], fplan.producer):
            raise AssertionError("phase 20b: the attached stacked plan's "
                                 "entry differs from the cache's plan")
        p = d.producer.clone()
        p[0] = bad.producer
        return {**lay, "dplan": dataclasses.replace(d, producer=p)}
    staged0 = eng.counters["swaps_staged"]
    try:
        eng.swap_params(_replace_layer(params0, lpath.split("/"), corrupt))
    except PlanVerificationError as e:
        f = e.findings[0]
        refusals["swap"] = f"{e.where}: {f.rule} at {f.path}"
        if e.where != "swap-staging" or f.rule not in (
                "forest-gathers", "forest-producers"):
            raise AssertionError(f"phase 20b: swap: {e}")
    else:
        raise AssertionError("phase 20b: the corrupted generation staged")
    after = serve_round()
    print(f"[phase 20b] swap_params refused at {refusals['swap']}; "
          f"swaps_staged {staged0} -> {eng.counters['swaps_staged']}, "
          f"generation {eng.generation}; 4 requests x 16 tokens before and "
          f"after equal: {before == after}")
    if eng.counters["swaps_staged"] != staged0 or eng.generation or \
            before != after:
        raise AssertionError(f"phase 20b: staged "
                             f"{eng.counters['swaps_staged']}, tokens "
                             f"{before} != {after}")
    numbers["refusals"] = refusals
    numbers["wrong_outputs"] = wrong
    del eng
    _gates().take("phase 20b (corrupted ForestPlans)")

    # -- (c) a truncated bundle is refused before its hash --------------------
    work = os.path.join(ROOT, "build", "phase20")
    shutil.rmtree(work, ignore_errors=True)
    real_sha = bundles._sha256
    try:
        manifest = write_bundles(raw, cfg.quant, work,
                                 cache=plancache.PlanCache())
        victim = os.path.join(work, manifest["layers"][lpath]["files"][0][
            "file"])
        with open(victim, "r+b") as f:
            f.truncate(os.path.getsize(victim) // 2)
        hashed = []
        bundles._sha256 = lambda p: hashed.append(str(p)) or real_sha(p)
        try:
            load_bundles(raw, cfg.quant, work)
        except PlanVerificationError as e:
            f = e.findings[0]
            numbers["truncated"] = f"{e.where}: {f.rule}"
            if e.where != "bundle-load" or f.rule != "bundle-file":
                raise AssertionError(f"phase 20c: {e}")
        else:
            raise AssertionError("phase 20c: a truncated bundle loaded")
        print(f"[phase 20c] {manifest['n_files']} bundles written, "
              f"{os.path.basename(victim)} truncated: refused at "
              f"{numbers['truncated']}; files hashed before the refusal "
              f"{len(hashed)}, the truncated one among them: "
              f"{victim in hashed}")
        if victim in hashed or manifest["n_files"] != 7:
            raise AssertionError(f"phase 20c: _sha256 read {hashed}")
    finally:
        bundles._sha256 = real_sha
        shutil.rmtree(work, ignore_errors=True)
    _gates().take("phase 20c (truncated bundle)")
    launches = {"phase 20 (the plan verifier)": {
        k.__name__: k.launches for k in kernels}}
    print(f"[phase 20] launches {launches}")
    return launches, numbers


def _poison_pool(pool, table, steps, ps, vmax):
    """A copy of ``pool`` with every row B2 has no business reading
    poisoned: NaN in an exact pool's K and V rows, 127 in an int8 pool's
    and NaN in its ks / vs scales, on every page no slot's live extent
    names and in each slot's last live page past its step. With ``vmax``
    (an exact pool under int8 attention, whose V scale is the |V| max over
    the whole page-table extent, the null page 0 of the dead entries
    included) V is poisoned only on the pages no table entry names.
    Returns (poisoned copy, poisoned rows of K, of V)."""
    import torch
    n_pages = pool["k"].shape[0]
    live = torch.zeros((n_pages, ps), dtype=torch.bool)
    named = torch.zeros((n_pages,), dtype=torch.bool)
    named[0] = True
    for s, step in enumerate(steps.tolist()):
        for j, page in enumerate(table[s].tolist()):
            named[page] = True
            lanes = step + 1 - j * ps
            if lanes > 0:
                live[page, :min(lanes, ps)] = True
    dead_k = ~live
    dead_v = ~named[:, None].expand(n_pages, ps) if vmax else dead_k
    out = {}
    for name, a in pool.items():
        dead = (dead_v if name in ("v", "vs") else dead_k).to(a.device)
        fill = 127 if a.dtype == torch.int8 else float("nan")
        out[name] = torch.where(dead[:, :, None, None], torch.full_like(
            a, fill), a)
    return out, int(dead_k.sum()), int(dead_v.sum())


def tracelint_path():
    """Phase 21: the program half of the analysis on the card.

    (0) The walker's op spellings (``walker.spelling_report``) on the
    card's torch, on ``cuda`` and on its CPU: every probe caught by the set
    meant to catch it, the ops printed; RoPE's frequencies from a Python
    base equal the old ``torch.tensor(theta)`` formula's bit for bit at
    smollm-135m's, chatglm3-6b's (partial) and llama1-7b's head dims on
    ``cuda``. (a) ``python -m repro_torch.analysis.lint --backend
    engine_cuda --backend lut_cuda --plans --budgets --device cuda`` (its
    ``main``, in process): exit 0, ``[tracelint]``, ``[planlint]`` and
    ``[costcheck]`` lines, ``paged-attention`` built with one
    ``kernel:B2`` site a layer, ``forest`` on ``engine_cuda`` one
    ``kernel:B1`` site, the ``live-page-decode`` budget reported held by
    (c) on both backends, not evaluated (B2's pool reads are a kernel
    site). (b) ``lint_backend(..., reduced=False,
    n_layers=2)`` on ``cuda`` for both backends, smollm-135m at its
    published widths: 0 findings, the same kernel sites (and 7 B1 or B3
    sites a layer in each decode), no scatter in ``forest``; seconds per
    backend. (c) The live-page budget's kernel half: at smollm-135m's
    heads (KV 3, G 3, hd 64), B = 4, page_size 16, max_len 256, ragged
    steps, in all four pool layouts, every row B2 has no business reading
    poisoned (``_poison_pool``): B2's output bit-identical to the clean
    call; and the oracle ``paged-decode``'s ``pool_gather_bytes_growth``
    on ``cuda`` above the 1.25 budget. (d) Controls on ``cuda``: an
    ``.item()``, a ``.cpu()`` and a ``torch.tensor`` each give
    ``no-host-callback``; ``swap_trace_count`` on ``engine_torch`` gives 1
    aligned and 2 widened. Every part raises on failure and prints what
    it found, with the kernels' launches."""
    import contextlib
    import io
    from collections import Counter

    import torch
    from repro_torch.analysis import find_violations, walker
    from repro_torch.analysis.costcheck import growth_ratio, swap_trace_count
    from repro_torch.analysis.lint import main as lint_main
    from repro_torch.analysis.programs import lint_backend
    from repro_torch.configs import get_config
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.transitive_forest import transitive_forest
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.launch.specs import serve_config
    kernels = (transitive_forest, transitive_gemm_cuda, paged_attention)
    n_layers = 2

    # -- (0) the op spellings on this torch; RoPE's frequencies ---------------
    for dev in ("cuda", "cpu"):
        report = walker.spelling_report(dev)
        missed = [k for k, v in report.items() if not v["caught"]]
        print(f"[phase 21] op spellings on {dev} (torch "
              f"{torch.__version__}): " + "; ".join(
                  f"{k}: {' '.join(v['ops'])}" for k, v in report.items()))
        if missed:
            raise AssertionError(f"phase 21: probes not caught on {dev}: "
                                 f"{missed}")
    for arch in ("smollm_135m", "chatglm3_6b", "llama1_7b"):
        cfg = get_config(arch)
        rot_d = cfg.hd // 2 if cfg.rope_2d else cfg.hd
        exps = -torch.arange(0, rot_d, 2, dtype=torch.float32,
                             device="cuda") / rot_d
        new = torch.pow(float(cfg.rope_theta), exps)
        old = torch.pow(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                     device="cuda"), exps)
        if not torch.equal(new, old):
            raise AssertionError(f"phase 21: RoPE frequencies of {arch} "
                                 f"differ on the card")
    print("[phase 21] RoPE frequencies from a Python base equal the "
          "torch.tensor(theta) formula's bit for bit on cuda at "
          "smollm-135m's, chatglm3-6b's (partial) and llama1-7b's head "
          "dims")

    # -- (a) the lint CLI on the card -----------------------------------------
    out_json = os.path.join(ROOT, "build", "phase21_lint.json")
    os.makedirs(os.path.dirname(out_json), exist_ok=True)
    _zero(kernels)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(["--backend", "engine_cuda", "--backend", "lut_cuda",
                        "--plans", "--budgets", "--device", "cuda",
                        "--json", out_json])
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"[phase 21a] {line}")
    with open(out_json) as f:
        doc = json.load(f)
    os.remove(out_json)
    sites = {r["backend"]: r["kernel_sites"] for r in doc["backends"]}
    print(f"[phase 21a] exit {rc} in {dt:.1f}s | kernel sites {sites} | "
          f"launches {_counts(kernels)}")
    if rc != 0 or not all(tag in text for tag in ("[tracelint]",
                                                  "[planlint]",
                                                  "[costcheck]")):
        raise AssertionError(f"phase 21a: lint exit {rc}")
    for b in ("engine_cuda", "lut_cuda"):
        if sites[b]["paged-attention"].get(
                "kernel:B2.paged_attention") != n_layers:
            raise AssertionError(f"phase 21a: {b} paged-attention sites "
                                 f"{sites[b]['paged-attention']}")
    if sites["engine_cuda"]["forest"] != {"kernel:B1.forest_narrow": 1}:
        raise AssertionError(f"phase 21a: forest sites "
                             f"{sites['engine_cuda']['forest']}")
    # B2 reads the pool: the live-page budget is held by (c), not evaluated
    live = [r for r in doc["budgets"] if r["budget"] == "live-page-decode"]
    if len(live) != 2 or not all(
            "kernel:B2" in r.get("held_by", "") and "value" not in r
            for r in live):
        raise AssertionError(f"phase 21a: live-page-decode rows {live}")

    # -- (b) the published widths ---------------------------------------------
    for b, kernel in (("engine_cuda", "kernel:B1.forest_narrow"),
                      ("lut_cuda", "kernel:B3.tgemm_lut")):
        _zero(kernels)
        t0 = time.perf_counter()
        progs, found = lint_backend(b, device="cuda", reduced=False,
                                    n_layers=n_layers)
        dt = time.perf_counter() - t0
        tag = f"phase 21b ({b}, full width)"
        by = {p.name: p for p in progs}
        ks = {p.name: dict(Counter(s.op for s in p.trace if s.is_kernel))
              for p in progs}
        scatter = [s.op for s in by["forest"].trace
                   if s.is_in(walker.SCATTER_OPS)] if "forest" in by else []
        print(f"[{tag}] smollm-135m d_model 576, {n_layers} layers: "
              f"{len(progs)} programs, {len(found)} findings in {dt:.1f}s | "
              f"kernel sites {ks} | launches {_counts(kernels)}")
        for f in found:
            print(f"[{tag}] {f.format()}")
        if found or any(p.skipped for p in progs):
            raise AssertionError(f"{tag}: {len(found)} findings")
        if ks["paged-attention"].get("kernel:B2.paged_attention") != \
                n_layers or ks["decode"].get(kernel) != 7 * n_layers:
            raise AssertionError(f"{tag}: kernel sites {ks}")
        if b == "engine_cuda" and (ks["forest"] != {kernel: 1} or scatter):
            raise AssertionError(f"{tag}: forest sites {ks['forest']}, "
                                 f"scatters {scatter}")

    # -- (c) the live-page budget's kernel half -------------------------------
    base = serve_config(get_config("smollm_135m"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    b_, ps, max_len = 4, 16, 256
    pps = max_len // ps
    kv, g, hd = base.n_kv_heads, base.n_heads // base.n_kv_heads, base.hd
    n_pages = b_ * pps + 1 + 8                 # 8 pages no table names
    steps = torch.tensor([0, 37, 100, 200], dtype=torch.int32,
                         device="cuda")
    table = torch.zeros((b_, pps), dtype=torch.int32, device="cuda")
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(21)) + 1
    nxt = 0
    for s in range(b_):
        n = pps if s % 2 else int(steps[s]) // ps + 1   # dead entries: 0
        table[s, :n] = perm[nxt:nxt + n].to(torch.int32)
        nxt += n
    q = torch.randn((b_, 1, kv * g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    named = len(set(table.flatten().tolist()) - {0})
    for layout, (name, quant, bits) in ATTN_LAYOUTS.items():
        cfg = base.replace(quant_attention=quant)
        pool = _attn_pool(layout, (n_pages, ps, kv, hd), gen)
        bad, dk, dv = _poison_pool(pool, table.cpu(), steps.cpu(), ps,
                                   vmax=quant and bits == 16)
        clean = paged_attention(q, pool, table, steps, cfg, hd ** -0.5)
        dirty = paged_attention(q, bad, table, steps, cfg, hd ** -0.5)
        same = torch.equal(clean, dirty)
        what = "NaN" if bits == 16 else "127, NaN scales"
        print(f"[phase 21c] B2 {name}: {dk} K rows and {dv} V rows of "
              f"{n_pages * ps} poisoned ({what}), steps {steps.tolist()}, "
              f"{named} of {n_pages - 1} pages named by the table: output "
              f"bit-identical to the clean call: {same}")
        if not same or not torch.isfinite(dirty.float()).all():
            raise AssertionError(f"phase 21c: B2 {name} read a dead row")
    ratio, values = growth_ratio("lut_cuda", "paged-decode",
                                 "pool_gather_bytes", device="cuda")
    print(f"[phase 21c] the oracle paged-decode's pool_gather_bytes_growth "
          f"on cuda: {ratio:.3f} ({values}) > the 1.25 budget: "
          f"{ratio > 1.25}")
    if not ratio > 1.25:
        raise AssertionError(f"phase 21c: oracle growth {ratio}")

    # -- (d) positive controls on the card ------------------------------------
    x = torch.ones(4, device="cuda")
    controls = {
        "item": lambda v: v * float(v.sum().item()),
        "cpu()": lambda v: v.cpu() + 1.0,
        "torch.tensor": lambda v: v * torch.tensor(2.0, device="cuda")}
    fired = {}
    for name, fn in controls.items():
        found = find_violations(fn, x, rules=("no-host-callback",))
        fired[name] = [f.primitive for f in found]
        if not found:
            raise AssertionError(f"phase 21d: no-host-callback silent on "
                                 f"{name}")
    counts = {a: swap_trace_count(backend="engine_torch", device="cuda",
                                  aligned=a) for a in (True, False)}
    print(f"[phase 21d] no-host-callback fires on cuda: {fired} | "
          f"swap_trace_count on engine_torch: aligned {counts[True]}, "
          f"widened {counts[False]}")
    if counts != {True: 1, False: 2}:
        raise AssertionError(f"phase 21d: swap_trace_count {counts}")


def ops_path():
    """The public kernel API on the card: each function of
    repro_torch.kernels.ops once at a serving shape, plus the routes that
    take T outside {4, 8} (``transitive_gemm`` at T=6 and T=16, the one
    B3 kernel at its width 8, counted apart; ``transitive_forest`` from a
    T=9 and a T=15 DevicePlan, packed at the first call and run by the
    fused int16 kernel ``forest_fused16``; from a T=16 DevicePlan (8x32),
    packed into a SparseForestPlan and run by ``forest_sparse``, counted
    in ``launch_sparse.launches``; and from a T=16 DevicePlan whose
    compact table does not fit shared memory (``complete_forest_plan``,
    30,000 slots in one tile), run by the two-pass kernel, which counts
    with ``forest_fused16`` in ``transitive_forest_dense.launches``) and
    ``rg_lru`` over float64,
    with the launch counts set to 0 just before and read just after; then
    each result against its kernel's plain version (exact for the integer
    kernels and for float64 B5, the reference's tolerances for B4 and f32
    B5)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import (BatchedTransitiveEngine,
                                         compile_plan, complete_forest_plan)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.rg_lru import rg_lru_cuda
    from repro_torch.kernels.transitive_forest import (forest_plain,
                                                       transitive_forest)
    from repro_torch.kernels.transitive_forest_dense import (
        transitive_forest_dense)
    from repro_torch.kernels.transitive_forest_sparse import launch_sparse
    from repro_torch.kernels.transitive_gemm import transitive_gemm_cuda
    from repro_torch.kernels.w4a8_gemm import w4a8_gemm_cuda
    gen = torch.Generator(device="cuda").manual_seed(7)

    def ints(shape, lim):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda",
                             dtype=torch.int8)

    x, w = ints((4, 576), 128), ints((1536, 576), 8)
    xg, wg = ints((4, 12, 128), 128), ints((576, 12, 128), 8)
    xq, wq = ints((4, 576), 128), ints((1536, 576), 8)
    sx = torch.rand((4, 1), generator=gen, device="cuda") + 0.5
    sg = torch.rand((1536, 9), generator=gen, device="cuda") + 0.5
    hx = torch.randn((4, 2048, 4096), generator=gen, device="cuda")
    ha = torch.rand((4, 2048, 4096), generator=gen, device="cuda") * 0.2 + 0.8
    h0 = torch.randn((4, 4096), generator=gen, device="cuda")
    wf = np.random.default_rng(7).integers(-8, 8, size=(192, 576))
    dplan = compile_plan(BatchedTransitiveEngine(4, 8).plan(wf),
                         device="cuda")
    xf = torch.randint(-128, 128, (576, 4), generator=gen, device="cuda",
                       dtype=torch.int32)
    dplan9 = compile_plan(BatchedTransitiveEngine(4, 9).plan(wf),
                          device="cuda")
    dplan15 = compile_plan(BatchedTransitiveEngine(4, 15).plan(
        np.random.default_rng(15).integers(-8, 8, size=(16, 30))),
        device="cuda")
    xf15 = torch.randint(-128, 128, (30, 4), generator=gen, device="cuda",
                         dtype=torch.int32)
    dplan16 = compile_plan(BatchedTransitiveEngine(4, 16).plan(
        np.random.default_rng(16).integers(-8, 8, size=(8, 32))),
        device="cuda")
    xf16 = torch.randint(-128, 128, (32, 4), generator=gen, device="cuda",
                         dtype=torch.int32)
    crowded = compile_plan(complete_forest_plan(16, 30000, 64, seed=16),
                           device="cuda")
    xc = torch.randint(-128, 128, (16, 4), generator=gen, device="cuda",
                       dtype=torch.int32)
    hx64 = torch.randn((2, 256, 512), generator=gen, device="cuda",
                       dtype=torch.float64)
    ha64 = (torch.rand((2, 256, 512), generator=gen, device="cuda",
                       dtype=torch.float64) * 0.2 + 0.8)
    kernels = (transitive_forest, transitive_gemm_cuda, w4a8_gemm_cuda,
               rg_lru_cuda, transitive_forest_dense, launch_sparse)
    for k in kernels:
        k.launches = 0
    outs = (ops.transitive_gemm(x, w, w_bits=4),
            ops.transitive_gemm_grouped(xg, wg, w_bits=4),
            ops.w4a8_gemm(xq, sx, wq, sg, group=64),
            ops.rg_lru(hx, ha, h0),
            ops.transitive_forest(dplan, xf))
    fast = transitive_gemm_cuda.launches       # T=8 so far; T=6, 16 next
    outs += (ops.transitive_gemm(x, w, w_bits=4, t=6),
             ops.transitive_forest(dplan9, xf),
             ops.transitive_gemm(x, w, w_bits=4, t=16),
             ops.transitive_forest(dplan15, xf15),
             ops.rg_lru(hx64, ha64, h0[:2, :512]),
             ops.transitive_forest(dplan16, xf16),
             ops.transitive_forest(crowded, xc))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    launches["transitive_gemm_cuda at T=6, 16"] = (
        transitive_gemm_cuda.launches - fast)
    print(f"[ops] launches: {launches}")
    if launches != {"transitive_forest": 1, "transitive_gemm_cuda": 4,
                    "w4a8_gemm_cuda": 1, "rg_lru_cuda": 2,
                    "transitive_forest_dense": 3, "launch_sparse": 1,
                    "transitive_gemm_cuda at T=6, 16": 2}:
        raise AssertionError(f"ops API launches wrong: {launches}")
    exact = ((outs[0], ref.transitive_matmul_ref(x, w, 4)),
             (outs[1], ref.transitive_matmul_grouped_ref(xg, wg, 4)),
             (outs[4], forest_plain(dplan, xf)),
             (outs[5], ref.transitive_matmul_ref(x, w, 4, 6)),
             (outs[6], forest_plain(dplan9, xf)),
             (outs[7], ref.transitive_matmul_ref(x, w, 4, 16)),
             (outs[8], forest_plain(dplan15, xf15)),
             (outs[9], ref.rg_lru_ref(hx64, ha64, h0[:2, :512])),
             (outs[10], forest_plain(dplan16, xf16)),
             (outs[11], forest_plain(crowded, xc)))
    for got, want in exact:
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError("ops API integer result != plain version")
    if not torch.allclose(outs[2], ref.w4a8_matmul_ref(xq, sx, wq, sg),
                          rtol=2e-3, atol=1e-2):
        raise AssertionError("ops.w4a8_gemm beyond rtol 2e-3, atol 1e-2")
    if not torch.allclose(outs[3], ref.rg_lru_ref(hx, ha, h0), rtol=3e-4,
                          atol=3e-4):
        raise AssertionError("ops.rg_lru beyond 3e-4")
    print("[ops] transitive_gemm (T=8, 6 and 16), transitive_gemm_grouped, "
          "transitive_forest (T=8; 9 and 15 through forest_fused16; 16 "
          "through forest_sparse, and through the two-pass kernel where "
          "the compact table does not fit), rg_lru in float64 exact; "
          "w4a8_gemm and f32 rg_lru within tolerance")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0])
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    seconds = build.build_all()
    print(f"[build] {', '.join(build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f}s ("
          + ", ".join(f"{n} {t:.1f}s" for n, t in seconds.items())
          + "; transitive_gemm's includes its 21 unaligned instances)")
    for name in build.SOURCES:
        print(f"[ptxas {name}] {build.ptxas_report(name)}")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    phase_s = {}

    from repro_torch.launch.device_events import device_events
    retried = {}

    def timed(name, fn, *a, **kw):
        t, r = time.perf_counter(), device_events.retries
        out = fn(*a, **kw)
        phase_s[name] = round(time.perf_counter() - t, 1)
        if device_events.retries > r:
            retried[name] = device_events.retries - r
        if _GATE_METER:                 # what the gates verified otherwise
            _gates().take(f"phase {name}")
        return out
    forest = timed("B1", check_forest, flush)
    attention = timed("B2", check_attention, flush)
    tgemm = timed("B3", check_tgemm, flush)
    tgemm["llama1_7b"] = timed("B3 llama1-7b", check_tgemm_arch, flush)
    generic = timed("B3g", check_tgemm_generic, flush)
    dense = timed("B1d", check_forest_dense, flush)
    sparse = timed("B1s", check_forest_sparse, flush)
    w4a8 = timed("B4", check_w4a8, flush)
    rglru = timed("B5", check_rg_lru, flush)
    timed("4", check_reduced_serve)
    _gates()                # count the plan verifier's gates from here on
    launches, toks, raw, params, cfg = timed("5", main_path)
    lut = timed("6", lut_path, toks, raw, cfg)
    layouts = timed("8-10", layout_paths, raw, cfg)
    layouts[0] = (lut["paged_attention"], "phase 6 (lut_cuda serve)")
    bundles = os.path.join(ROOT, "build", "phase18_bundles")
    try:
        fleet, fleet_numbers = timed("18", fleet_path, raw, params, cfg,
                                     toks, bundles)
        mesh = timed("22", mesh_path, toks, bundles)
    finally:
        shutil.rmtree(bundles, ignore_errors=True)
    del raw, params
    archs = timed("11, 11b", dense_paths)
    for arch, shapes, ms in (
            ("recurrentgemma-9b", RGEMMA_SHAPES, (4, 512, 2100)),
            ("moonshot-v1-16b-a3b", MOONSHOT_SHAPES, (4, 512)),
            ("llama4-maverick-400b-a17b", LLAMA4_SHAPES, (4,)),
            ("xlstm-125m", XLSTM_SHAPES, (4, 512)),
            ("whisper-tiny", WHISPER_SHAPES, (4, 6000)),
            ("llama-3.2-vision-90b", VISION_SHAPES, (4,))):
        tgemm[arch.replace("-", "_").replace(".", "_")] = timed(
            f"B3 {arch}", check_tgemm_arch, flush, arch, shapes, ms)
    forest["xlstm_125m"], worst = timed(
        "B1 xlstm-125m", check_forest_arch, flush, "xlstm-125m",
        XLSTM_SHAPES, (4, 512))
    forest["max_abs_err"] = max(forest["max_abs_err"], worst)
    recurrent, rglru["phase 12"] = timed("12", recurrent_path, flush)
    archs |= timed("13, 13b", moe_paths)
    xlstm, oneshot = timed("14", xlstm_path)
    cross, cross_numbers = timed("15, 15b", cross_paths)
    oneshot |= cross_numbers
    oneshot_launches = xlstm | cross
    timed("16", train_path)
    b5_train, rglru["training"] = timed("16b", train_recurrent_path, flush)
    del flush
    accuracy, accuracy_numbers = timed("17", accuracy_path)
    paper, paper_numbers = timed("19", paper_path)
    verifier, verifier_numbers = timed("20", verifier_path)
    timed("21", tracelint_path)
    ops = timed("7", ops_path)
    print(f"[seconds] by phase: {phase_s} | profiler reads taken again "
          f"(a launch lost at a window's edge) by phase: {retried}, "
          f"{device_events.retries} in all; the most primer and spin "
          f"records one read lost: {device_events.primers_lost}")
    kernels = [
        {"name": "transitive_forest", "route": "cuda",
         "source": "src/repro_torch/csrc/transitive_forest.cu",
         "replaces": "src/repro/kernels/transitive_forest.py:47",
         "launches": launches["transitive_forest"],
         "launches_from": "phase 5 (engine_cuda serve)",
         "launches_in_other_phases": {
             **{phase: n["transitive_forest"] for phase, n in
                oneshot_launches.items() if n["transitive_forest"]},
             "phase 17 (quantize_eval, engine_cuda)":
                 accuracy["transitive_forest"],
             **{phase: n["transitive_forest"] for phase, n in
                (fleet | mesh).items()},
             **{phase: n["transitive_forest"] for phase, n in
                paper.items() if n["transitive_forest"]},
             **{phase: n["transitive_forest"] for phase, n in
                verifier.items()}},
         "fleet_phase": fleet_numbers,
         "plan_verifier": {"by_phase": _gates().log,
                           "phase_20": verifier_numbers}, **forest},
        {"name": "transitive_forest_dense", "route": "cuda",
         "source": "src/repro_torch/csrc/transitive_forest_dense.cu",
         "replaces": "src/repro/kernels/transitive_forest.py:47",
         "launches": ops["transitive_forest_dense"],
         "launches_from": "phase 7 (kernels.ops: T=9 and T=15 plans "
                          "through forest_fused16, a T=16 plan too large "
                          "for forest_sparse through the two-pass kernel)",
         **dense},
        {"name": "transitive_forest_sparse", "route": "cuda",
         "source": "src/repro_torch/csrc/transitive_forest_sparse.cu",
         "replaces": "src/repro/kernels/transitive_forest.py:47",
         "launches": ops["launch_sparse"],
         "launches_from": "phase 7 (kernels.ops: a T=16 plan through "
                          "forest_sparse)", **sparse}]
    kernels += [
        {"name": f"paged_attention/{ATTN_LAYOUTS[code][0]}", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:219",
         "launches": layouts[code][0], "launches_from": layouts[code][1],
         **attention[code]} for code in sorted(ATTN_LAYOUTS)]
    kernels[3]["launches_in_other_phases"] = {      # int8 pool + int8 attn
        phase: n["paged_attention"] for phase, n in
        (archs | fleet | mesh).items()}
    kernels[3]["launches_in_other_phases"] |= {
        phase: n["paged_attention"] for phase, n in (paper | verifier).items()
        if n["paged_attention"]}
    kernels += [
        {"name": "transitive_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/transitive_gemm.cu",
         "replaces": "src/repro/kernels/transitive_gemm.py:84",
         "launches": lut["transitive_gemm_cuda"],
         "launches_from": "phase 6 (lut_cuda serve)",
         "launches_in_other_phases": {
             **{phase: n["transitive_gemm_cuda"] for phase, n in
                (archs | recurrent | oneshot_launches).items()},
             "phase 17 (quantize_eval, lut_cuda)":
                 accuracy["transitive_gemm_cuda"],
             **{phase: n["transitive_gemm_cuda"] for phase, n in
                paper.items() if n["transitive_gemm_cuda"]}},
         "oneshot_phases": oneshot, "accuracy_phase": accuracy_numbers,
         "paper_phase": paper_numbers,
         **tgemm},
        {"name": "transitive_gemm_generic", "route": "cuda",
         "source": "src/repro_torch/csrc/transitive_gemm.cu",
         "replaces": "src/repro/kernels/transitive_gemm.py:84",
         "launches": ops["transitive_gemm_cuda at T=6, 16"],
         "launches_from": "phase 7 (kernels.ops, T=6 and T=16, through "
                          "tgemm_lut)", **generic},
        {"name": "w4a8_gemm", "route": "cuda",
         "source": "src/repro_torch/csrc/w4a8_gemm.cu",
         "replaces": "src/repro/kernels/w4a8_gemm.py:51",
         "launches": ops["w4a8_gemm_cuda"],
         "launches_from": "phase 7 (kernels.ops)", **w4a8},
        {"name": "rg_lru", "route": "cuda",
         "source": "src/repro_torch/csrc/rg_lru.cu",
         "replaces": "src/repro/kernels/rg_lru.py:51",
         "launches": ops["rg_lru_cuda"],
         "launches_from": "phase 7 (kernels.ops)",
         "launches_in_other_phases": {
             **{phase: n["rg_lru_cuda"] for phase, n in recurrent.items()},
             **b5_train},
         **rglru},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
