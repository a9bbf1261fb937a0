"""Serve meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

JAX serves a mesh from one process; PyTorch's idiom is SPMD: one process
per rank, a :class:`~torch.distributed.device_mesh.DeviceMesh`, and DTensor
placements. ``make_serve_mesh`` takes the ``--mesh data=4`` spelling and
builds a mesh over a *prefix* of the ranks of the process group that is
already initialised, so a 2-way cell in a 4-rank world is legal, as in
the reference (whose mesh takes a prefix of the local devices).

:class:`RankWorld` starts those ranks: N spawned processes that join one
process group (``gloo``, through a ``FileStore`` in a private temporary
directory, so parallel test workers never race for a TCP port) and run
the functions handed to them, with a hard timeout on every call. It is
the counterpart of the reference's forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=N``): on a CPU host
it fakes N devices, and on one card every rank shares it. :func:`run_ranks`
is the one-shot form. If any rank raises, the call raises.

``make_production_mesh`` (the 16 x 16 / 2 x 16 x 16 TPU layouts) is
ROADMAP item A10.3.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable

__all__ = ["make_local_mesh", "parse_mesh_spec", "make_serve_mesh",
           "RankWorld", "run_ranks", "run_cli_on_mesh"]

# Seconds the other ranks get to report after one rank raised, before the
# world is ended (they may be stuck in a collective that rank never joins).
GRACE = 10.0


def parse_mesh_spec(arg: str) -> dict[str, int]:
    """``"data=4"`` / ``"pod=2,data=2"`` -> an ordered ``{axis: size}``."""
    axes: dict[str, int] = {}
    for part in arg.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        try:
            n = int(size)
        except ValueError:
            n = 0
        if not name or n < 1:
            raise ValueError(
                f"mesh spec entries are axis=size (e.g. 'data=4'), "
                f"got {part!r} in {arg!r}")
        if name in axes:
            raise ValueError(f"duplicate mesh axis {name!r} in {arg!r}")
        axes[name] = n
    return axes


def make_serve_mesh(spec: str | dict[str, int], device=None):
    """DeviceMesh for a serve cell from a ``--mesh`` spec string or axis
    dict, over the first ``prod(sizes)`` ranks of the initialised process
    group (axis order = spec order), on ``device``'s type (``cuda`` unless
    asked otherwise). Every rank of the world calls it (it creates process
    groups); a rank outside the prefix gets the mesh with no coordinate."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device

    axes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    n = 1
    for s in axes.values():
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 0
    if n > world:
        raise ValueError(
            f"mesh {axes} needs {n} ranks but the process group has "
            f"{world} (start {n} ranks with repro_torch.launch.mesh."
            f"run_ranks / RankWorld, or torchrun --nproc-per-node {n})")
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(axes.values())),
                      mesh_dim_names=tuple(axes))


def make_local_mesh(data: int = 1, model: int = 1, device=None):
    """A ``(data, model)`` mesh over the first ``data * model`` ranks."""
    return make_serve_mesh({"data": data, "model": model}, device=device)


# -- ranks ------------------------------------------------------------------

def _rank_main(rank: int, world: int, store: str, backend: str,
               threads: int | None, timeout_s: float, conn) -> None:
    """A rank's loop: join the group, then run each (fn, args, kwargs)
    received and send back ("ok", result) or ("err", traceback)."""
    import torch
    import torch.distributed as dist

    if threads is not None:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():        # ranks beyond the cards share them
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        while True:
            job = conn.recv()
            if job is None:
                break
            fn, args, kwargs = job
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except BaseException:              # noqa: BLE001 - reported
                conn.send(("err", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
        conn.close()


class RankWorld:
    """``n`` spawned ranks in one ``gloo`` process group.

    ``run(fn, *args)`` calls ``fn(*args)`` on every rank (``fn`` must be
    importable by name: a module-level function) and returns the ranks'
    results in rank order. If any rank raises, ``run`` raises with that
    rank's traceback; ranks still inside a collective after ``GRACE``
    seconds are then ended with the world (the next ``run`` starts a fresh
    one). Each call has ``timeout`` seconds; a timed-out world is ended.
    Use as a context manager, or call :meth:`close`."""

    def __init__(self, n: int, *, timeout: float = 300.0,
                 threads: int | None = None):
        if n < 1:
            raise ValueError(f"a world needs at least one rank, got {n}")
        self.n = n
        self.timeout = timeout
        self.threads = threads
        self._procs: list = []
        self._conns: list = []
        self._dir: str | None = None

    def start(self) -> "RankWorld":
        import multiprocessing as mp
        if self._procs:
            return self
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="rankworld-")
        store = os.path.join(self._dir, "store")
        for rank in range(self.n):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, daemon=True,
                            args=(rank, self.n, store, "gloo", self.threads,
                                  self.timeout, child))
            p.start()
            child.close()
            self._procs.append(p)
            self._conns.append(parent)
        return self

    def run(self, fn: Callable, *args, **kwargs) -> list[Any]:
        import time
        self.start()
        for c in self._conns:
            c.send((fn, args, kwargs))
        results: list = [None] * self.n
        pending = set(range(self.n))
        errors: dict[int, str] = {}
        deadline = time.monotonic() + self.timeout
        while pending:
            if time.monotonic() > deadline:
                self.close()
                if errors:
                    break                     # report the first error below
                raise TimeoutError(
                    f"{getattr(fn, '__name__', fn)} did not finish on "
                    f"ranks {sorted(pending)} within {self.timeout:.0f}s")
            for r in list(pending):
                if not self._procs[r].is_alive() and not \
                        self._conns[r].poll():
                    self.close()
                    raise RuntimeError(f"rank {r} died running "
                                       f"{getattr(fn, '__name__', fn)}")
                if self._conns[r].poll(0.01):
                    status, value = self._conns[r].recv()
                    pending.discard(r)
                    if status == "ok":
                        results[r] = value
                    else:
                        errors[r] = value
                        deadline = min(deadline, time.monotonic()
                                       + GRACE)
        if errors:
            r = min(errors)
            raise RuntimeError(f"rank {r} of {self.n} raised in "
                               f"{getattr(fn, '__name__', fn)}:\n"
                               f"{errors[r]}")
        return results

    def close(self) -> None:
        for c in self._conns:
            try:
                c.send(None)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        for c in self._conns:
            c.close()
        self._procs, self._conns = [], []
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __enter__(self) -> "RankWorld":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def run_ranks(n: int, fn: Callable, *args, timeout: float = 900.0,
              threads: int | None = None, **kwargs) -> list[Any]:
    """Start ``n`` ranks, run ``fn(*args, **kwargs)`` on each, end them;
    the ranks' results in rank order (raises if any rank raised)."""
    with RankWorld(n, timeout=timeout, threads=threads) as world:
        return world.run(fn, *args, **kwargs)


def _cli_rank(entry: Callable, argv: list[str]) -> int:
    """A rank of :func:`run_cli_on_mesh`: ``entry(argv)`` with rank 0's
    standard output kept and the others' dropped; its exit code (an
    entry point that returns something other than an int exited 0)."""
    import contextlib
    import io

    import torch.distributed as dist
    quiet = (contextlib.redirect_stdout(io.StringIO())
             if dist.get_rank() else contextlib.nullcontext())
    with quiet:
        try:
            rc = entry(argv)
            return rc if isinstance(rc, int) else 0
        except SystemExit as e:
            return e.code if isinstance(e.code, int) else 1


def run_cli_on_mesh(entry: Callable, argv: list[str], n: int,
                    device) -> int:
    """Run a command-line entry point (``entry(argv)``, module level) on
    ``n`` ranks of a fresh world, after building the CUDA kernels once in
    this process where ``device`` is the card (``kernels/build.py`` writes
    its ``.so`` files without a lock, so ranks that built at once would
    race); the largest exit code of the ranks. Rank 0 prints. The host's
    cores are split between the ranks (torch threads)."""
    from repro_torch.device import resolve_device
    if resolve_device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    codes = run_ranks(n, _cli_rank, entry, list(argv),
                      threads=max(1, (os.cpu_count() or 1) // n))
    return max(codes)
