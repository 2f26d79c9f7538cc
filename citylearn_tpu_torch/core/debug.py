"""Toggleable runtime physics assertions for the stepped district.

The reference guards its step with inline asserts — demand never exceeds
the device's max output (``building.py:1825-1829``), electricity
consumption is non-negative (``building.py:1831-1834``), downward
flexibility is non-negative (``building.py:657-665``) — which vanish
under ``python -O``. Here a module flag that ``district_step`` reads on
every call: off (the default), the step builds no condition, launches
nothing more and never waits on the device; on, it reduces each
condition on the device and reads all of them back in one transfer.

Usage::

    from citylearn_tpu_torch.core import debug
    debug.enable_checks(True)
"""

from __future__ import annotations

import torch

_CHECKS_ENABLED = False


def enable_checks(on: bool = True) -> None:
    """Turn runtime physics checks on/off; the next step reads the flag."""
    global _CHECKS_ENABLED
    _CHECKS_ENABLED = bool(on)


def checks_enabled() -> bool:
    return _CHECKS_ENABLED


class PhysicsCheckError(AssertionError):
    pass


def runtime_check(conditions: dict) -> None:
    """Assert every (name -> bool tensor) condition holds elementwise:
    each is reduced by ``torch.all`` where it lives and the flags come to
    the host in one synchronizing copy. Raises :class:`PhysicsCheckError`
    naming the violated conditions in the order given. No-op unless
    :func:`enable_checks` was called."""
    if not _CHECKS_ENABLED:
        return
    names = tuple(conditions)
    flags = torch.stack([torch.all(torch.as_tensor(c)) for c in conditions.values()])
    bad = [n for n, ok in zip(names, flags.cpu().tolist()) if not ok]
    if bad:
        raise PhysicsCheckError(f"physics invariant violated: {', '.join(bad)}")
