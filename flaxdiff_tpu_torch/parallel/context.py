"""The active mesh (counterpart of ``flaxdiff_tpu/parallel/context.py``).

Modules are built from static config (strings, ints); a mesh is runtime
state. The trainer declares the mesh once here (``use_mesh``) and the
attention dispatch (``ops/attention.py``, backends ``"ring"`` and
``"ulysses"``) picks it up at call time: no mesh is threaded through the
modules' constructors, and any attention layer can run sequence-parallel
without its parent knowing.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

_active_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "flaxdiff_tpu_torch_active_mesh", default=None)
_seq_axis: contextvars.ContextVar[str] = contextvars.ContextVar(
    "flaxdiff_tpu_torch_seq_axis", default="seq")


def set_active_mesh(mesh, seq_axis: str = "seq") -> None:
    """Declare the mesh (a ``DeviceMesh``) and the name of its sequence
    dim for the code that follows; None clears it."""
    _active_mesh.set(mesh)
    _seq_axis.set(seq_axis)


def get_active_mesh():
    return _active_mesh.get()


def get_seq_axis() -> str:
    return _seq_axis.get()


@contextlib.contextmanager
def use_mesh(mesh, seq_axis: str = "seq"):
    """``set_active_mesh`` for the scope of a ``with`` block."""
    tok_m = _active_mesh.set(mesh)
    tok_s = _seq_axis.set(seq_axis)
    try:
        yield mesh
    finally:
        _active_mesh.reset(tok_m)
        _seq_axis.reset(tok_s)


def seq_parallel_active() -> bool:
    """True when the active mesh has a sequence dim of more than one rank."""
    from .mesh import axis_size
    mesh = get_active_mesh()
    return mesh is not None and axis_size(mesh, get_seq_axis()) > 1
