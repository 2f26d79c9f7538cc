"""Batched piecewise-linear curve lookups: :func:`interp_reference`
matches the reference battery's ``idx = max(0, argmax(q <= x) - 1)`` +
segment interpolation semantics (reference
``citylearn/energy_model.py:1070-1109``), including the quirky fall-back
to the *first* segment when the query exceeds every knot (all-False
``argmax`` returns 0); :func:`interp_linear` is ``numpy.interp``, which
the reference charger uses (``electric_vehicle_charger.py:252-281``)."""

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


def interp_linear(q: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """``numpy.interp`` of ``q`` (..., C) on per-row curves ``xs``/``ys``
    (C, K), in the arithmetic of ``jax.numpy.interp``: constant beyond
    either end, and the left knot's value on a zero-width segment (the
    padding repeats the last knot)."""
    xs = xs.expand(q.shape + xs.shape[-1:])
    ys = ys.expand(q.shape + ys.shape[-1:])
    n = xs.shape[-1]
    i = torch.clamp((xs <= q[..., None]).sum(-1), 1, n - 1)     # searchsorted, side="right"
    take = lambda a, j: torch.gather(a, -1, j[..., None])[..., 0]
    x0, x1, y0, y1 = take(xs, i - 1), take(xs, i), take(ys, i - 1), take(ys, i)
    dx = x1 - x0
    flat = torch.abs(dx) <= 2.0 ** -46                          # spacing(float32 eps)
    f = torch.where(flat, y0, y0 + ((q - x0) / torch.where(flat, torch.ones_like(dx), dx))
                    * (y1 - y0))
    f = torch.where(q < xs[..., 0], ys[..., 0], f)
    return torch.where(q > xs[..., -1], ys[..., -1], f)
