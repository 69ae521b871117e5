"""Model-level layout flags (``repro.models.flags``).

Each flag picks between two parameter layouts of the same computation, as
the reference's does; the forwards take either layout, so a flag changes
what ``init_*`` builds and what the ``*_axes`` trees name, not the result.

* ``head_sharded_layouts`` — 3-D (d, H, Dh) projection weights ((H, Dh, d)
  for ``wo``) where the head count divides the production tensor-parallel
  width of 16, so that a sharding decides per whole head; else the 2-D
  (d, H * Dh) layout.
* ``fused_w13`` — one (d, 2, f) gate+up projection in the dense MLP; else
  ``w1`` / ``w3`` (d, f) apart.

Both default to True, as in the reference.  The flags are process-global,
like the reference's; :func:`flags` sets some for the length of a ``with``.
"""

from __future__ import annotations

import contextlib

__all__ = ["get", "set_flag", "flags"]

_FLAGS = {
    "head_sharded_layouts": True,
    "fused_w13": True,
}


def get(name: str) -> bool:
    return _FLAGS[name]


def set_flag(name: str, value: bool) -> None:
    if name not in _FLAGS:
        raise KeyError(name)
    _FLAGS[name] = bool(value)


@contextlib.contextmanager
def flags(**kw):
    old = dict(_FLAGS)
    for k, v in kw.items():
        set_flag(k, v)
    try:
        yield
    finally:
        _FLAGS.update(old)
