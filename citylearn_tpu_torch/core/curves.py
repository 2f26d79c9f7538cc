"""Batched piecewise-linear curve lookup matching the reference's
``idx = max(0, argmax(q <= x) - 1)`` + segment interpolation semantics
(reference ``citylearn/energy_model.py:1070-1109``), including the quirky
fall-back to the *first* segment when the query exceeds every knot
(all-False ``argmax`` returns 0)."""

from __future__ import annotations

import torch


def interp_reference(q: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Interpolate ``q`` (..., B) on per-building curves ``xs``/``ys`` (B, P).

    Curves are padded by exact repetition of the last knot
    (:func:`citylearn_tpu_torch.compiler.seeding.pad_curve`), which keeps
    ``argmax`` and segment indexing identical to the unpadded reference.
    """
    xs = xs.expand(q.shape + xs.shape[-1:])
    ys = ys.expand(q.shape + ys.shape[-1:])
    match = (q[..., None] <= xs).to(torch.int8)
    first = torch.argmax(match, dim=-1)              # 0 when all-False, like numpy
    idx = torch.clamp(first - 1, min=0)
    take = lambda a, i: torch.gather(a, -1, i[..., None])[..., 0]
    x0, x1 = take(xs, idx), take(xs, idx + 1)
    y0, y1 = take(ys, idx), take(ys, idx + 1)
    return y0 + (q - x0) * (y1 - y0) / (x1 - x0)
