"""Trace points: the two hooks the model, engine and kernel code call so
that a recorder (:mod:`repro_torch.analysis.walker`) can see one call's
scopes and kernel launches.

This module sits below every layer that calls it and imports nothing of
the port, so the kernels, ``core`` and ``models`` depend on it and not
on ``repro_torch.analysis``. With no recorder active each hook costs one
global read:

* :func:`scope` names the ops run inside it (the counterpart of
  ``jax.named_scope``); ``loop=True`` marks them a loop body;
* :func:`note_launch` hands a ctypes kernel launch, which the dispatcher
  cannot see, to the active recorder.

:func:`recording` installs a recorder: any object with
``launch(name, inputs, outputs)``. :func:`current_scopes` is the stack
of ``(name, loop)`` entries the recorder reads at each op.
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["scope", "note_launch", "recording", "current_scopes"]

_ACTIVE = 0          # recorders active in the process: the one global read
_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_op_recorder", default=None)
_SCOPES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_op_scopes", default=())
_NULL = contextlib.nullcontext()


class _Scope:
    __slots__ = ("_entry", "_token")

    def __init__(self, name: str, loop: bool):
        self._entry = (name, loop)

    def __enter__(self):
        self._token = _SCOPES.set(_SCOPES.get() + (self._entry,))
        return self

    def __exit__(self, *exc) -> bool:
        _SCOPES.reset(self._token)
        return False


def scope(name: str, *, loop: bool = False):
    """Name the ops run inside (``with scope("quantize_kv"): ...``); with
    ``loop=True`` they are a loop body (``in_loop``). A context-variable
    push and pop while a recorder is active, one global read otherwise."""
    if not _ACTIVE:
        return _NULL
    return _Scope(name, loop)


def note_launch(name: str, inputs=(), outputs=()) -> None:
    """Hand a ctypes kernel launch to the active recorder (``name`` =
    ``"B2.paged_attention"``): its input tensors and the output tensors
    it writes in place. Nothing happens unless a recorder is active."""
    if not _ACTIVE:
        return
    rec = _RECORDER.get()
    if rec is not None:
        rec.launch(name, tuple(inputs), tuple(outputs))


def current_scopes() -> tuple[tuple[str, bool], ...]:
    """The enclosing scopes, outermost first, as ``(name, loop)``."""
    return _SCOPES.get()


@contextlib.contextmanager
def recording(rec):
    """Make ``rec`` the active recorder for the block."""
    global _ACTIVE
    token = _RECORDER.set(rec)
    _ACTIVE += 1
    try:
        yield rec
    finally:
        _ACTIVE -= 1
        _RECORDER.reset(token)
