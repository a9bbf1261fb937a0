"""Rank-side functions of the port's mesh tests (``tests/test_torch_serve_mesh.py``
and the mesh cases of other port test files).

Each function runs on every rank of a ``repro_torch.launch.mesh.RankWorld``
(a ``gloo`` CPU world) and returns plain data to the test process, which
holds it against the reference. This module imports torch and the port
only, so a rank never loads JAX; a rank keeps its meshes and models
between calls (``_STATE``), as one world serves a whole test module.
"""
import warnings

import torch
import torch.distributed as dist

_STATE: dict = {}


def mesh(spec: str):
    """The DeviceMesh of ``spec``, made once per world (every rank asks
    for the same specs in the same order: it is a collective)."""
    from repro_torch.launch.mesh import make_serve_mesh
    key = ("mesh", spec)
    if key not in _STATE:
        _STATE[key] = make_serve_mesh(spec, device="cpu")
    return _STATE[key]


def cell(raw_np: dict, backend: str, n_layers: int = 2):
    """(model, raw params) of reduced float32 smollm-135m with
    ``n_layers`` layers on ``backend``, from the reference's weights."""
    from repro_torch.configs import get_reduced
    from repro_torch.convert import params_from_reference
    from repro_torch.launch.specs import serve_config
    from repro_torch.models.model import Model
    key = ("cell", backend, n_layers)
    if key not in _STATE:
        cfg = serve_config(get_reduced("smollm_135m").replace(
            n_layers=n_layers), backend=backend).replace(dtype=torch.float32)
        model = Model(cfg, device="cpu")
        _STATE[key] = (model, params_from_reference(raw_np, "cpu"))
    return _STATE[key]


def _cache():
    """This rank's plan cache, kept across calls (the same weights are
    planned once per world) and made the process default."""
    from repro_torch.core.plancache import PlanCache, set_default_cache
    if "cache" not in _STATE:
        _STATE["cache"] = PlanCache(capacity=256)
        set_default_cache(_STATE["cache"])
    return _STATE["cache"]


def _plans_placed_equal(placed, host) -> tuple[bool, set]:
    """Every placed plan leaf is a DTensor whose whole value equals its
    host twin's; the placements seen."""
    from torch.distributed.tensor import DTensor
    from repro_torch.analysis.walker import named_tensors
    seen, ok = set(), True
    for path, leaf in named_tensors(placed).items():
        if ".dplan." not in f".{path}.":
            continue
        ok &= isinstance(leaf, DTensor)
        seen.add(tuple(map(str, leaf.placements)))
        ok &= torch.equal(leaf.full_tensor(), named_tensors(host)[path])
    return ok, seen


def generate(raw_np, backend, tokens, spec="data=4"):
    """One-rank ``greedy_generate`` and the mesh's, the plan-cache lookups
    the mesh run made after attach, and whether the placed plans equal
    their host twins."""
    from repro_torch.train.serve_step import greedy_generate
    model, raw = cell(raw_np, backend)
    m = mesh(spec)
    cache = _cache()
    p1 = model.attach_device_plans(raw)
    batch = {"tokens": torch.from_numpy(tokens)}
    t1 = greedy_generate(model, p1, batch, max_len=24, n_steps=5)
    pm = model.attach_device_plans(raw, mesh=m)
    cache.reset_stats()
    tn = greedy_generate(model, pm, batch, max_len=24, n_steps=5, mesh=m)
    s = cache.stats()
    ok, seen = _plans_placed_equal(pm, p1)
    return {"one": t1.numpy(), "mesh": tn.numpy(),
            "lookups": (s["hits"], s["misses"]), "plans_equal": ok,
            "plan_placements": seen}


def caches_and_trace(raw_np, backend, tokens):
    """The prefilled caches' placements, tracelint on the mesh decode step,
    and ``sharding-integrity`` on the batch-sharded caches and on the same
    caches left replicated."""
    from repro_torch import analysis
    from repro_torch.analysis.rules import get_rule
    from repro_torch.distributed import sharding
    from repro_torch.train.serve_step import (_place_batch, _prefill_placed,
                                              make_decode_step)
    model, raw = cell(raw_np, backend)
    m = mesh("data=4")
    _cache()
    params = sharding.local_tree(model.attach_device_plans(raw, mesh=m))
    placed = _place_batch({"tokens": torch.from_numpy(tokens)}, m)
    logits, caches = _prefill_placed(model, params, placed, 24)
    leaves = analysis.walker.named_tensors(caches)
    placements = {p: tuple(map(str, t.placements)) for p, t in leaves.items()}
    local = sharding.local_chunks(caches)
    tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    trace = analysis.find_violations(
        make_decode_step(model), params, local, tok, 8,
        rules=("no-host-callback", "static-shapes", "dtype-purity"))
    rule = get_rule("sharding-integrity")
    sharded = rule.check(analysis.LintProgram(
        name="decode", rules=(rule.name,), mesh=m,
        arrays={"kv-cache": caches}))
    everywhere = sharding.spec(mesh=m)            # Replicate() per mesh dim
    replicated = {p: sharding.distribute(t.full_tensor(), m, everywhere)
                  for p, t in leaves.items()}
    fired = rule.check(analysis.LintProgram(
        name="decode", rules=(rule.name,), mesh=m,
        arrays={"kv-cache": replicated}))
    return {"placements": placements,
            "local_rows": {p: t.to_local().shape for p, t in leaves.items()},
            "global_rows": {p: tuple(t.shape) for p, t in leaves.items()},
            "trace_findings": [f.format() for f in trace],
            "sharded_findings": [f.format() for f in sharded],
            "replicated_findings": [f.format() for f in fired]}


def _pool_digest(pool) -> str:
    import hashlib
    from repro_torch.analysis.walker import named_tensors
    h = hashlib.sha256()
    for p, t in sorted(named_tensors(pool).items()):
        h.update(p.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def serve(raw_np, backend, prompts, gen, spec="data=4"):
    """ServeEngine's fast path (B2's path, bucketed prefill) on one rank
    and on the mesh: tokens by request, the mesh engine's counters and
    packed-decode placements, and a digest of its page pool."""
    from repro_torch.serve import ServeEngine
    model, raw = cell(raw_np, backend)
    m = mesh(spec)
    _cache()
    out = {}
    for name, where in (("one", None), ("mesh", m)):
        params = model.attach_device_plans(raw, mesh=where)
        eng = ServeEngine(model, params, n_slots=4, max_len=16, page_size=4,
                          mesh=where, paged_kernel=True, bucket_prefill=True,
                          device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for p in prompts:
                eng.submit(p, gen)
            done = eng.run()
        out[name] = {r.rid: r.tokens for r in done}
    out["batched_calls"] = eng.counters["prefill_batched_calls"]
    out["decode_signatures"] = eng.stats()["decode_signatures"]
    out["placements"] = {k: tuple(map(str, v))
                         for k, v in eng.decode_placements.items()}
    out["pool"] = _pool_digest(eng.pool)
    return out


def hot_swap(raw_np, raw1_np, backend, prompts, gen):
    """A swap mid-flight on a data=4 engine, generation 1 built by a
    ``ReplanWorker(mesh=)``: tokens by (generation, prompt), the engine's
    signature and swap counters, and whether both generations' plans
    were placed on the mesh."""
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.sharding import ShardingDropWarning
    from torch.distributed.tensor import DTensor
    from repro_torch.fleet import ReplanWorker, build_generation
    from repro_torch.serve import ServeEngine
    model, raw = cell(raw_np, backend)
    raw1 = params_from_reference(raw1_np, "cpu")
    m = mesh("data=4")
    _cache()
    gen0 = build_generation(model, raw, gen=0, mesh=m)
    worker = ReplanWorker(model, mesh=m, reference=gen0.params)
    try:
        ticket = worker.submit(raw1)
        assert ticket.wait(120) and ticket.error is None, ticket.error
    finally:
        worker.stop()
    gen1 = ticket.generation
    placed = all(isinstance(a, DTensor) for g in (gen0, gen1)
                 for a in g.params["blocks"]["b0"]["wq"]["dplan"]
                 .leaves().values())
    eng = ServeEngine(model, gen0.params, n_slots=4, max_len=16,
                      page_size=4, mesh=m, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ShardingDropWarning)
        for p in prompts[:2]:
            eng.submit(p, gen)
        eng.step()
        assert eng.swap_params(gen1.params) == 1
        submitted = 2
        while submitted < len(prompts) or eng.queue or eng.active:
            if submitted < len(prompts):
                eng.submit(prompts[submitted], gen)
                submitted += 1
            eng.step()
    s = eng.stats()
    return {"tokens": [(r.gen, list(r.prompt), r.tokens)
                       for r in eng.finished],
            "decode_signatures": s["decode_signatures"],
            "swaps": s["swaps"], "retired": s["generations_retired"],
            "placed": placed}


def load_bundles(raw_np, backend, bundle_dir, tokens):
    """Bundles attached onto a data=4 mesh: plan builds and lookups, and
    the mesh tokens."""
    from repro_torch.fleet import load_bundles as load
    from repro_torch.train.serve_step import greedy_generate
    model, raw = cell(raw_np, backend)
    m = mesh("data=4")
    cache = _cache()
    cache.reset_stats()
    params = load(raw, model.cfg.quant, bundle_dir, mesh=m)
    toks = greedy_generate(model, params, {"tokens": torch.from_numpy(
        tokens)}, max_len=24, n_steps=5, mesh=m)
    s = cache.stats()
    return {"builds": s["misses"], "hits": s["hits"], "mesh": toks.numpy()}


def sub_mesh(raw_np, backend, tokens):
    """A data=2 mesh in the 4-rank world: ranks 0 and 1 serve, ranks 2
    and 3 have no coordinate."""
    from repro_torch.train.serve_step import greedy_generate
    model, raw = cell(raw_np, backend)
    m = mesh("data=2")
    if m.get_coordinate() is None:
        return {"rank": dist.get_rank(), "in_mesh": False}
    _cache()
    toks = greedy_generate(model, model.attach_device_plans(raw, mesh=m),
                           {"tokens": torch.from_numpy(tokens)},
                           max_len=24, n_steps=5, mesh=m)
    return {"rank": dist.get_rank(), "in_mesh": True, "mesh": toks.numpy()}


def refusals(raw_np, backend):
    """The refusals: a mesh larger than the world, and a model axis above
    1 at greedy_generate and ServeEngine; the messages."""
    from repro_torch.launch.mesh import make_local_mesh, make_serve_mesh
    from repro_torch.serve import ServeEngine
    from repro_torch.train.serve_step import greedy_generate
    model, raw = cell(raw_np, backend)
    out = {}
    try:
        make_serve_mesh({"data": 8}, device="cpu")
    except ValueError as e:
        out["too_large"] = str(e)
    m = make_local_mesh(2, 2, device="cpu")
    out["local_mesh"] = (m.mesh_dim_names, tuple(m.shape))
    batch = {"tokens": torch.zeros((4, 8), dtype=torch.int64)}
    for name, call in (
            ("greedy_generate", lambda: greedy_generate(
                model, raw, batch, max_len=24, n_steps=2, mesh=m)),
            ("ServeEngine", lambda: ServeEngine(
                model, raw, n_slots=4, max_len=16, page_size=4, mesh=m,
                device="cpu"))):
        try:
            call()
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def lint_cli(argv):
    """``python -m repro_torch.analysis.lint`` inside the world (it uses
    the process group there is): (exit code, rank 0's output)."""
    import contextlib
    import io
    from repro_torch.analysis import lint
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint.main(list(argv))
    return rc, buf.getvalue()



def plan_placement():
    """``shard_device_plan``'s three forms of specs on a stack of four
    plans (DevicePlan and ForestPlan), its refusals, and the
    ``plan_specs`` hook that ``attach_device_plans(mesh=)`` consults when
    no specs are given."""
    import numpy as np
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import backend as BK
    from repro_torch.core.engine import BatchedTransitiveEngine
    from repro_torch.core.plancache import attach_device_plans
    from repro_torch.distributed.sharding import local_tree
    from repro_torch.quant import QuantConfig
    m = mesh("data=4")
    rng = np.random.default_rng(0)
    eng = BatchedTransitiveEngine(bits=4, t=8)
    plans = [eng.plan(rng.integers(-8, 8, size=(16, 32))) for _ in range(4)]
    out = {}
    for name in ("engine_torch", "engine_cuda"):
        b = BK.get_backend(name)
        host = b.compile(plans, device="cpu")
        fields = BK.plan_fields(host)
        first = fields[0]
        forms = {"none": None, "all": (Shard(0),),
                 "map": {first: (Shard(0),)}}
        for form, specs in forms.items():
            placed = b.compile(plans, device="cpu", mesh=m, specs=specs)
            leaves = placed.leaves()
            out[(name, form)] = {
                "dtensor": all(isinstance(a, DTensor)
                               for a in leaves.values()),
                "placements": {f: tuple(map(str, a.placements))
                               for f, a in leaves.items()},
                "equal": all(torch.equal(local_tree(a), host.leaves()[f])
                             for f, a in leaves.items()),
                "rows": {f: a.to_local().shape[0]
                         for f, a in leaves.items()}}
        for bad, exc in (({"nope": (Replicate(),)}, ValueError),
                         ("data", TypeError)):
            try:
                BK.shard_device_plan(host, m, bad)
            except exc as e:
                out[(name, "refused", exc.__name__)] = str(e)
    calls = []

    class Placed(BK.EngineTorchBackend):
        name = "custom_placed"

        def plan_specs(self, where):
            calls.append(where)
            return (Replicate(),)

    BK.register_backend(Placed())
    try:
        cfg = QuantConfig(mode="ptq", w_bits=4, a_bits=8, group=0,
                          backend="custom_placed")
        qw = torch.as_tensor(rng.integers(-8, 8, size=(16, 32)),
                             dtype=torch.int8)
        layer = {"qw": qw, "sg": torch.ones((16, 1))}
        got = attach_device_plans({"l": layer}, cfg, mesh=m)
        out["hook_calls"] = [c is m for c in calls]
        out["hook_placed"] = isinstance(got["l"]["dplan"].signs, DTensor)
        attach_device_plans({"l": layer}, cfg, mesh=m,
                            specs=(Replicate(),))
        out["hook_calls_after_explicit"] = len(calls)
    finally:
        BK._REGISTRY.pop("custom_placed", None)
    return out


def lint_plans_on_mesh(spec):
    """``planlint.lint_plans`` with the lowerings placed on ``spec``'s
    mesh: the findings, the artifacts verified, and the placements the
    placed ``device`` lowering carried into the verifier."""
    from repro_torch.analysis import planlint
    seen = set()
    verify = planlint.verify_device_plan

    def recording(device, *args, **kw):
        for a in device.leaves().values():
            if hasattr(a, "placements"):
                seen.add(tuple(map(str, a.placements)))
        return verify(device, *args, **kw)
    planlint.verify_device_plan = recording
    try:
        report, findings = planlint.lint_plans(
            ["engine_torch", "engine_cuda"], device="cpu", mesh=mesh(spec))
    finally:
        planlint.verify_device_plan = verify
    return {"findings": [f.format() for f in findings],
            "artifacts": [r["artifacts"] for r in report],
            "placed": sorted(seen)}


def swap_traces():
    """``costcheck.swap_trace_count(mesh=)`` on ``data=2`` (the engine's
    two slots split one a rank), aligned and with the new generation's
    plans widened."""
    from repro_torch.analysis.costcheck import swap_trace_count
    m = mesh("data=2")
    if m.get_coordinate() is None:
        return None
    return tuple(swap_trace_count(backend="engine_torch", device="cpu",
                                  mesh=m, aligned=a) for a in (True, False))
