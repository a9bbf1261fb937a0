"""Build the lintable serving programs for one registered backend (port of
``repro.analysis.programs``).

For a backend name from ``repro_torch.core.backend.list_backends()`` this
module builds what the serve path runs — prefill, the dense decode step,
the paged (continuous-batching) decode step, its twin on a hot-swapped
second weight generation, the live-page attention kernel's decode, the
bucketed batched prefill and the backend's forest execution — and
records each as :class:`~repro_torch.analysis.rules.LintProgram`
evidence: an op trace of one call (``walker.record``), a second trace on
other input values of the same signature (``static-shapes``' schedule
check), and the KV leaves each decode must update in place
(``kv-donation``). Each program runs once unrecorded first, as a jit
traces a compiled program: caches filled at a first call (a quantizer's
divisor, a DevicePlan's packing) are not part of the step.

Plans are built in a private plan cache, so linting leaves the process
cache, its counters and its gates' counts as they were. ``paged-
attention`` is built only where the B2 kernel runs (``cuda``): on the
CPU its wrapper runs the plain version, the gather oracle that
``paged-decode`` already is, so the program is listed as skipped with
that reason. Program construction is capability-driven off the registry,
so the lint CLI holds for every backend ``list_backends()`` returns, and
a backend's ``lint_exempt`` tags opt it out of the rules that do not
apply to it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.rules import Finding, LintProgram, run_rules
from repro_torch.analysis.walker import named_tensors, record
from repro_torch.core.backend import EngineConfig, get_backend

__all__ = ["build_programs", "lint_backend", "PROGRAM_RULES"]

# which rules guard which program (minus per-backend lint_exempt tags)
PROGRAM_RULES = {
    "prefill": ("no-host-callback", "static-shapes", "dtype-purity"),
    "decode": ("no-host-callback", "static-shapes", "dtype-purity",
               "kv-donation", "sharding-integrity"),
    "paged-decode": ("no-host-callback", "static-shapes", "dtype-purity",
                     "kv-donation"),
    # the same paged step on a second weight generation built by
    # fleet.build_generation and pad-aligned against the first: a swap
    # must not cost the serving invariants
    "paged-decode-swapped": ("no-host-callback", "static-shapes",
                             "dtype-purity", "kv-donation"),
    # the fast paths: the live-page kernel's decode and the bucketed
    # batched prefill, held to the invariants of the oracles they shadow
    "paged-attention": ("no-host-callback", "static-shapes", "dtype-purity",
                        "kv-donation"),
    "prefill-bucketed": ("no-host-callback", "static-shapes",
                         "dtype-purity"),
    "forest": ("gather-only-levels", "no-host-callback", "static-shapes"),
}

KERNEL_ONLY = ("built only where the B2 kernel runs (cuda): on the CPU "
               "its wrapper runs the plain version, the gather oracle that "
               "paged-decode already is")


def _program(name, backend, fn, args_a, args_b, **kw) -> LintProgram:
    """Run ``fn`` once, then record it on ``args_a`` and on ``args_b``
    (other values, the same signature)."""
    fn(*args_a)
    trace = record(fn, *args_a)
    retrace = record(fn, *args_b)
    return LintProgram(name=name, backend=backend, rules=PROGRAM_RULES[name],
                       trace=trace, retrace=retrace, **kw)


def _pool_leaves(tree, at: str) -> dict[str, torch.Tensor]:
    """{path in the call's result: leaf} for a KV tree the call returns
    as its result's element ``at``."""
    return {f"{at}.{p}": t for p, t in named_tensors(tree).items()}


def build_programs(backend_name: str, *, device=None,
                   arch: str = "smollm-135m", reduced: bool = True,
                   n_layers: int = 2, batch: int = 4, prompt_len: int = 8,
                   max_len: int = 16, page_size: int = 4, w_bits: int = 4,
                   mesh=None, programs: tuple[str, ...] | None = None
                   ) -> list[LintProgram]:
    """The lintable program set for ``backend_name`` on ``device``
    (``cuda`` unless asked otherwise), at the arch's reduced widths or,
    with ``reduced=False``, its published ones (``n_layers`` layers
    either way). ``programs`` restricts the set (the budgets build one).
    ``mesh=`` (the sharding evidence) waits for ROADMAP item A10."""
    if mesh is not None:
        raise NotImplementedError(
            "build_programs(mesh=): multi-device serving is not ported; "
            "it waits for ROADMAP item A10")
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core.plancache import PlanCache, set_default_cache
    from repro_torch.device import resolve_device
    from repro_torch.fleet import build_generation
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    from repro_torch.train.serve_step import make_decode_step

    want = set(PROGRAM_RULES if programs is None else programs)
    dev = resolve_device(device)
    backend = get_backend(backend_name)
    base = get_reduced(arch) if reduced else get_config(arch)
    cfg = serve_config(base.replace(n_layers=n_layers), w_bits=w_bits,
                       backend=backend_name)
    model = Model(cfg, device=dev)
    on_card = dev.type == "cuda"
    cache = PlanCache()
    prev = set_default_cache(cache)
    try:
        params = model.attach_device_plans(model.init(0, on_device=on_card))
    finally:
        set_default_cache(prev)
    gen = torch.Generator().manual_seed(1)

    def draw(*shape, high=cfg.vocab):
        return torch.randint(0, high, shape, generator=gen,
                             dtype=torch.int32).to(dev)

    progs: list[LintProgram] = []

    # -- prefill ------------------------------------------------------------
    if "prefill" in want:
        def prefill(p, b):
            return model.prefill(p, b, max_len)
        progs.append(_program(
            "prefill", backend_name, prefill,
            (params, {"tokens": draw(batch, prompt_len)}),
            (params, {"tokens": draw(batch, prompt_len)})))

    # -- decode (dense caches, written in place) ------------------------------
    if "decode" in want:
        caches = model.init_cache(batch, max_len)
        progs.append(_program(
            "decode", backend_name, make_decode_step(model),
            (params, caches, draw(batch, 1), prompt_len),
            (params, caches, draw(batch, 1), prompt_len + 1),
            donate_expect={"kv-cache": _pool_leaves(caches, "[1]")}))

    paged = model.supports_paged() is None
    pps = max_len // page_size
    n_pages = batch * pps + 1

    def paged_args(p, pool, live: bool):
        """(params, pool, tokens, page table, steps): the reference's
        zeros, or live slots on pages 1.. at ragged steps."""
        if not live:
            return (p, pool, torch.zeros((batch, 1), dtype=torch.int32,
                                         device=dev),
                    torch.zeros((batch, pps), dtype=torch.int32, device=dev),
                    torch.zeros((batch,), dtype=torch.int32, device=dev))
        table = torch.arange(1, n_pages, dtype=torch.int32).reshape(batch,
                                                                    pps)
        steps = torch.arange(batch, dtype=torch.int32) * 3 % max_len
        return (p, pool, draw(batch, 1), table.to(dev), steps.to(dev))

    def paged_program(name, p, kernel):
        pool = model.init_page_pool(n_pages, page_size)

        def step(p, pl, t, pi, st):
            return model.decode_step_paged(p, pl, t, pi, st, kernel=kernel)
        return _program(name, backend_name, step,
                        paged_args(p, pool, False), paged_args(p, pool, True),
                        donate_expect={"kv-page-pool":
                                       _pool_leaves(pool, "[1]")})

    if paged and "paged-decode" in want:
        progs.append(paged_program("paged-decode", params, False))
    if paged and "paged-decode-swapped" in want:
        swapped = build_generation(
            model, model.init(2, on_device=on_card), ref=params, gen=1,
            cache=cache)
        progs.append(paged_program("paged-decode-swapped", swapped.params,
                                   False))
    if paged and "paged-attention" in want:
        if on_card:
            progs.append(paged_program("paged-attention", params, True))
        else:
            progs.append(LintProgram(
                name="paged-attention", backend=backend_name,
                rules=PROGRAM_RULES["paged-attention"], skipped=KERNEL_ONLY))

    # -- bucketed batched prefill (one padded bucket shape) -----------------
    if paged and "prefill-bucketed" in want:
        lb = max(page_size, 8)
        pool = model.init_page_pool(n_pages, page_size)

        def bucketed(p, t, pl, *ix):
            return model.prefill_paged_batched(
                p, t, pl, prefix_page_ids=ix[0], prefix_lens=ix[1],
                suffix_lens=ix[2], write_page_ids=ix[3], write_offs=ix[4],
                write_pos=ix[5])

        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=dev)
        lanes = torch.arange(batch * lb, dtype=torch.int32).reshape(batch, lb)
        live = (draw(batch, lb), pool, z(batch, 0),
                z(batch), torch.full((batch,), lb - 1, dtype=torch.int32,
                                     device=dev),
                (1 + lanes // page_size % (n_pages - 1)).to(dev),
                (lanes % page_size).to(dev), (lanes % lb).to(dev))
        zeros = (z(batch, lb), pool, z(batch, 0), z(batch),
                 torch.full((batch,), lb, dtype=torch.int32, device=dev),
                 z(batch, lb), z(batch, lb), z(batch, lb))
        progs.append(_program("prefill-bucketed", backend_name, bucketed,
                              (params, *zeros), (params, *live)))

    # -- forest (the plan's level loop / the forest kernel) -----------------
    if "forest" in want and backend.needs_plan and backend.device_resident:
        from repro_torch.core.engine import BatchedTransitiveEngine
        rng = np.random.default_rng(0)
        w = rng.integers(-8, 8, size=(5, 32))
        ecfg = EngineConfig(w_bits=4, t=8, groups=1)
        plan = BatchedTransitiveEngine(bits=4, t=8).plan(w)
        dplan = backend.compile(plan, device=dev)
        qw = torch.as_tensor(w, dtype=torch.int8, device=dev)

        def x_of(seed):
            return torch.as_tensor(np.random.default_rng(seed).integers(
                -128, 128, size=(3, 32)), dtype=torch.int8, device=dev)

        def forest(xx):
            return backend.execute(xx, qw, plan, dplan, ecfg)
        progs.append(_program("forest", backend_name, forest, (x_of(1),),
                              (x_of(2),)))
    return progs


def lint_backend(backend_name: str, *, device=None, mesh=None,
                 only: tuple[str, ...] | None = None,
                 **build_kw) -> tuple[list[LintProgram], list[Finding]]:
    """Build and lint one backend's program set.

    Returns (programs, findings); the backend's ``lint_exempt`` tags are
    honored, ``only`` restricts to a rule subset (CLI ``--rules``).
    """
    backend = get_backend(backend_name)
    progs = build_programs(backend_name, device=device, mesh=mesh,
                           **build_kw)
    findings: list[Finding] = []
    exempt = frozenset(getattr(backend, "lint_exempt", ()))
    for prog in progs:
        findings.extend(run_rules(prog, exempt=exempt, only=only))
    return progs, findings
