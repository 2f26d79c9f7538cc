"""Single-district temperature and set-point post-pass of the neighborhood
family (see :mod:`citylearn_tpu_torch.ops.neighborhood`).

Under open-loop plans the LSTM temperature prediction (reference
``building.py:3000-3078``) and the occupant thermostat interaction
(``building.py:3160-3353``) are the same for every district: their only
control-dependent inputs are the demand observations the kernel records,
never a district's storage state. So they run once, for one district,
after the kernel: on the card as the post-pass kernel P6, on the CPU as
its plain version, a step loop over :func:`core.step.dynamics_update` and
:func:`core.step.occupant_update` (:mod:`citylearn_tpu_torch.ops.postpass`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from citylearn_tpu_torch.core.types import DistrictParams, StaticConfig
from citylearn_tpu_torch.ops.postpass import OccState, neighborhood_postpass


def temp_setpoint_series(cfg: StaticConfig, params: DistrictParams, cool_obs: torch.Tensor,
                         heat_obs: torch.Tensor, n_steps: int, data_offset: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    Optional[OccState]]:
    """Temperature and effective set-point series of ONE district.

    ``cool_obs``/``heat_obs``: (S, B) demand-observation series (``device
    output + storage discharge``, building.py:1435-1437; the neighborhood
    kernel's ``R_COUT``/``R_HOUT`` rows, the tanks being inert on this
    family), on the device of ``params``.

    Returns ``(temp (S, B), csp_eff (S, B), hsp_eff (S, B), final_state)``
    where ``final_state`` carries the occupant overrides after the episode
    for ``kpi_table``'s patch of the unwritten row (None without
    occupants). On a CUDA device this is one launch of the post-pass
    kernel."""
    return neighborhood_postpass(cfg, params, cool_obs, heat_obs, n_steps, data_offset)
