"""Observation encoding for the batched trainer.

Compiles the reference's encoder pipeline (``rlc.py:207-240``: periodic
sin/cos, one-hot day_type, min-max, remove-feature) into index and
parameter tensors, so the encoded observations of every district come
from the ``obs_static`` rows by one gather and a few elementwise
operations.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from citylearn_tpu_torch.compiler.spec import DistrictSpec

PERIODIC = {"month": 12, "hour": 24}
ONEHOT = {"day_type": [1, 2, 3, 4, 5, 6, 7, 8], "daylight_savings_status": [0, 1]}


class EncoderSpec(NamedTuple):
    """Per output slot: source column (into the union obs matrix), kind and
    two parameters. kinds: 0 minmax, 1 sin, 2 cos, 3 onehot(class=p1),
    4 constant zero (padding slot for heterogeneous-district stacking).
    A stack of specs over the agent axis carries a leading ``A`` axis."""
    src: torch.Tensor        # (K_out,) int64
    kind: torch.Tensor       # (K_out,) int32
    p1: torch.Tensor         # (K_out,) float32
    p2: torch.Tensor         # (K_out,) float32


def build_encoder_spec(spec: DistrictSpec, layout, building_index: int,
                       remove: List[str] = ("net_electricity_consumption",),
                       device=None) -> EncoderSpec:
    b = spec.buildings[building_index]
    src, kind, p1, p2 = [], [], [], []
    for name in b.active_observations:
        col = layout.column(name)
        if name in remove:
            continue
        if name in PERIODIC:
            x_max = float(PERIODIC[name])
            src += [col, col]
            kind += [1, 2]
            p1 += [x_max, x_max]
            p2 += [0.0, 0.0]
        elif name in ONEHOT:
            for cls in ONEHOT[name]:
                src.append(col)
                kind.append(3)
                p1.append(float(cls))
                p2.append(0.0)
        else:
            src.append(col)
            kind.append(0)
            p1.append(float(b.observation_low[name]))
            p2.append(float(b.observation_high[name]))
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    return EncoderSpec(src=torch.tensor(src, dtype=torch.int64, device=device),
                       kind=torch.tensor(kind, dtype=torch.int32, device=device),
                       p1=f32(p1), p2=f32(p2))


def pad_encoder_specs(specs: List[EncoderSpec]) -> List[EncoderSpec]:
    """Pad a list of per-building encoder specs to a common output width so
    they can be stacked over the agent axis (heterogeneous districts: each
    building may expose a different active-observation subset). Padding
    slots emit a constant 0.0 (kind 4) — harmless extra network inputs."""
    k_max = max(int(e.src.shape[0]) for e in specs)
    out = []
    for e in specs:
        n = k_max - int(e.src.shape[0])
        pad = lambda a, fill=0: torch.cat([a, torch.full((n,), fill, dtype=a.dtype,
                                                         device=a.device)])
        out.append(EncoderSpec(src=pad(e.src), kind=pad(e.kind, 4),
                               p1=pad(e.p1), p2=pad(e.p2)))
    return out


def stack_encoder_specs(specs: List[EncoderSpec]) -> EncoderSpec:
    """Stack padded per-building specs over a leading agent axis ``A``."""
    return EncoderSpec(*(torch.stack(xs) for xs in zip(*specs)))


def encode_obs(enc: EncoderSpec, obs_row: torch.Tensor) -> torch.Tensor:
    """(.., K_union) -> (.., K_out) encoded values. With a stacked spec
    (leading ``A`` axis), ``obs_row`` is (.., A, K_union): agent ``a``
    encodes row ``a`` with its own spec."""
    src = enc.src.expand(obs_row.shape[:-1] + enc.src.shape[-1:])
    x = torch.gather(obs_row, -1, src)
    zero = torch.zeros_like(x)
    minmax = torch.where(enc.p2 == enc.p1, zero, (x - enc.p1) / (enc.p2 - enc.p1))
    ang = 2 * math.pi * x / torch.clamp(enc.p1, min=1e-9)
    return torch.where(enc.kind == 0, minmax,
                       torch.where(enc.kind == 1, torch.sin(ang),
                                   torch.where(enc.kind == 2, torch.cos(ang),
                                               torch.where(enc.kind == 3,
                                                           (x == enc.p1).to(x.dtype),
                                                           zero))))
