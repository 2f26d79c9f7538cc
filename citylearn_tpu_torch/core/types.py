"""Tensor containers for the district engine.

Dataclasses of tensors take the place of the JAX package's flax
``PyTreeNode``s, with the same field names. Parameters carry a building
axis ``B``; input series are time-major ``(T, B)``. The episode state
of a batch of districts carries a leading district axis ``D`` on every
field (``t`` and ``data_offset`` are ``(D,)``), written out where the
JAX package vmaps.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"field.subfield": tensor}`` over a dataclass of tensors; the
    members of a tuple are keyed by their index (``"lstm_h.0"``)."""
    out = {}
    items = (enumerate(tree) if isinstance(tree, tuple)
             else ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)))
    for name, v in items:
        if dataclasses.is_dataclass(v) or isinstance(v, tuple):
            out.update(flatten(v, f"{prefix}{name}."))
        elif v is not None:
            out[f"{prefix}{name}"] = v
    return out


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree):
    """A copy of ``tree`` with ``fn`` applied to every tensor leaf (an
    absent block or leaf stays ``None``; tuples map member by member)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(map_tensors(fn, v) for v in tree)
    if not dataclasses.is_dataclass(tree):
        return fn(tree)
    return dataclasses.replace(tree, **{
        f.name: map_tensors(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})


@dataclasses.dataclass
class BatteryParams:
    """Per-building battery parameters, each ``(B,)`` float32 (curves ``(B, P)``).

    Mirrors resolved ``citylearn.energy_model.Battery`` construction
    (reference ``energy_model.py:872-1016``).
    """
    capacity: torch.Tensor
    nominal_power: torch.Tensor
    efficiency: torch.Tensor              # base technical efficiency
    loss_coefficient: torch.Tensor        # standby loss (already includes ratio)
    initial_soc: torch.Tensor
    depth_of_discharge: torch.Tensor
    capacity_loss_coefficient: torch.Tensor
    power_efficiency_curve_x: torch.Tensor  # (B, P)
    power_efficiency_curve_y: torch.Tensor
    capacity_power_curve_x: torch.Tensor
    capacity_power_curve_y: torch.Tensor
    # parity-mode NumPy-2 scalar provenance (bool (B,)): True when the
    # reference holds the parameter as a weak Python float, making
    # ``np.float32(soc) * capacity`` round to float32 (see core/battery.py)
    capacity_weak: Optional[torch.Tensor] = None
    dod_weak: Optional[torch.Tensor] = None


@dataclasses.dataclass
class HVACParams:
    """Heat pump / electric heater per building, ``(B,)`` each.

    ``is_heat_pump`` selects between Carnot-COP heat-pump math and
    constant-efficiency heater math (reference ``energy_model.py:157-451``).
    """
    is_heat_pump: torch.Tensor            # bool (B,)
    nominal_power: torch.Tensor
    efficiency: torch.Tensor
    target_cooling_temperature: torch.Tensor
    target_heating_temperature: torch.Tensor


@dataclasses.dataclass
class StorageTankParams:
    """Thermal storage tank per building, ``(B,)`` float32 each (reference
    ``energy_model.py:603-871``)."""
    capacity: torch.Tensor
    efficiency: torch.Tensor
    loss_coefficient: torch.Tensor
    initial_soc: torch.Tensor
    max_input_power: torch.Tensor         # +inf when unconstrained
    max_output_power: torch.Tensor
    capacity_weak: Optional[torch.Tensor] = None    # parity-mode provenance (B,) bool
    capacity_npf32: Optional[torch.Tensor] = None   # capacity itself np.float32 (B,) bool


@dataclasses.dataclass
class SeriesData:
    """Input time series, each ``(T, B)`` float32 over the simulation range.

    ``solar_generation`` is pre-scaled PV output (``pv_nominal * W_per_kW/1000``,
    positive kWh; reference ``energy_model.py:488``)."""
    non_shiftable_load: torch.Tensor
    cooling_demand: torch.Tensor
    heating_demand: torch.Tensor
    dhw_demand: torch.Tensor
    solar_generation: torch.Tensor
    outdoor_dry_bulb_temperature: torch.Tensor
    electricity_pricing: torch.Tensor
    carbon_intensity: torch.Tensor
    power_outage: torch.Tensor
    hvac_mode: torch.Tensor               # int32 (T, B)
    hour: torch.Tensor                    # int32 (T, B), 1-24 (drives RBC policies)
    indoor_dry_bulb_temperature: torch.Tensor          # ideal (without-control) temp
    indoor_dry_bulb_temperature_cooling_set_point: torch.Tensor
    indoor_dry_bulb_temperature_heating_set_point: torch.Tensor
    comfort_band: torch.Tensor
    occupant_count: torch.Tensor


@dataclasses.dataclass
class DynamicsParams:
    """Stacked LSTM temperature-dynamics weights for one *group* of
    buildings sharing identical shapes/channels (reference
    ``citylearn/dynamics.py:15-127``; weights loaded offline from the
    dataset ``.pth`` files). Districts with heterogeneous models carry a
    tuple of groups; ``member_indices`` maps group rows to building rows.
    Layer axes: ``(Bg, 4H, F_in)``, torch gate order i,f,g,o."""
    member_indices: torch.Tensor          # (Bg,) int32 building indices
    w_ih: Tuple[torch.Tensor, ...]        # per layer: (Bg, 4H, F or H)
    w_hh: Tuple[torch.Tensor, ...]        # per layer: (Bg, 4H, H)
    bias: Tuple[torch.Tensor, ...]        # per layer: (Bg, 4H) = b_ih + b_hh
    lin_w: torch.Tensor                   # (Bg, H)
    lin_b: torch.Tensor                   # (Bg,)
    norm_min: torch.Tensor                # (Bg, F)
    norm_max: torch.Tensor                # (Bg, F)
    # Pre-normalized data-driven channel values, (T, Bg, F); dynamic
    # channels (cooling/heating demand, indoor temperature) are zero and
    # overwritten each step.
    static_channels: torch.Tensor
    # per-building action-availability masks for partial-load control
    cooling_device_active: torch.Tensor   # (Bg,) bool
    heating_device_active: torch.Tensor
    cooling_or_heating_active: torch.Tensor


@dataclasses.dataclass
class OccupantParams:
    """Stochastic occupant thermostat interaction, stacked over buildings
    (reference ``occupant.py:18-99``, ``building.py:3160-3353``)."""
    a_increase: torch.Tensor              # (T, B)
    b_increase: torch.Tensor
    a_decrease: torch.Tensor
    b_decrease: torch.Tensor
    random_probability: torch.Tensor      # (T,) seeded uniform draws
    tree_children_left: torch.Tensor      # (B, 2, N) int32
    tree_children_right: torch.Tensor
    tree_feature: torch.Tensor
    tree_threshold: torch.Tensor          # (B, 2, N)
    tree_delta: torch.Tensor
    hold_time_steps: torch.Tensor         # (B,) int32
    lookback: torch.Tensor                # (B,) int32 dynamics warm-up gate


@dataclasses.dataclass
class ChargerParams:
    """EV chargers stacked over a district-wide charger axis ``C``
    (reference ``electric_vehicle_charger.py``); schedule tensors are
    episode-relative ``(T, C)`` like the reference's un-windowed charger
    data."""
    efficiency: torch.Tensor              # (C,)
    charge_eff_x: torch.Tensor            # (C, K) lookup knots at |action|
    charge_eff_y: torch.Tensor            # (C, K)
    discharge_eff_x: torch.Tensor         # (C, K)
    discharge_eff_y: torch.Tensor         # (C, K)
    max_charging_power: torch.Tensor
    min_charging_power: torch.Tensor
    max_discharging_power: torch.Tensor
    min_discharging_power: torch.Tensor
    building_index: torch.Tensor          # (C,) int32
    connected_ev: torch.Tensor            # (T, C) int32, -1 when none
    departure_time: torch.Tensor          # (T, C) float
    required_soc: torch.Tensor            # (T, C)
    capacity_kwh: torch.Tensor            # (T, C)
    # charging constraints (reference building.py:764-994); +inf = no limit
    cc_phase_index: torch.Tensor          # (C,) int32 district phase id, -1 none
    cc_building_limit: torch.Tensor       # (B,) float
    cc_phase_limit: torch.Tensor          # (P,) float
    cc_phase_building: torch.Tensor       # (P,) int32


@dataclasses.dataclass
class EVParams:
    """Electric vehicles stacked over ``V`` (reference
    ``electric_vehicle.py``), plus the precompiled SOC event tensors
    (see ``compiler/events.py``)."""
    battery: BatteryParams                # (V,) leaves
    force_soc: torch.Tensor               # (T, V) float, NaN = no event
    drift_mult: torch.Tensor              # (T, V) float, NaN = no drift


@dataclasses.dataclass
class WashingMachineParams:
    """Washing machines stacked over ``W`` (reference
    ``energy_model.py:1244-1398``). ``triggered_load[t]`` is the full
    truncated load-profile sum applied at the trigger step — the
    reference's scatter loop adds every profile entry to the *current*
    step (``energy_model.py:1327-1330``, the ``step`` variable is only
    bounds-checked), a shipped quirk that collapses the cycle onto the
    trigger step."""
    building_index: torch.Tensor          # (W,) int32
    wm_start: torch.Tensor                # (T, W) int32
    wm_end: torch.Tensor
    triggered_load: torch.Tensor          # (T, W) float


@dataclasses.dataclass
class DistrictParams:
    """Everything the district step and the trainer read, on one device."""
    series: SeriesData
    battery: BatteryParams
    cooling_device: HVACParams
    heating_device: HVACParams
    dhw_device: HVACParams
    cooling_storage: StorageTankParams
    heating_storage: StorageTankParams
    dhw_storage: StorageTankParams
    # (T, B, K_union) data-driven observation values: the observation
    # returned at sim-range row tau is obs_static[tau] (state-derived
    # columns read zero there; see core/params.DERIVED_ZERO_OBSERVATIONS)
    obs_static: torch.Tensor
    # one entry per group of buildings with identical LSTM shapes; empty
    # on a district without dynamics
    dynamics: Tuple[DynamicsParams, ...] = ()
    # absent (None) on a district without occupants, chargers or washing
    # machines
    occupant: Optional[OccupantParams] = None
    chargers: Optional[ChargerParams] = None
    evs: Optional[EVParams] = None
    washing_machines: Optional[WashingMachineParams] = None

    @property
    def device(self) -> torch.device:
        return self.battery.capacity.device

    def to(self, device) -> "DistrictParams":
        return map_tensors(lambda x: x.to(device), self)


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Hashable static configuration of a packed district (the same fields
    as the JAX package's, so both packages describe a district alike)."""
    n_buildings: int
    time_steps: int                      # episode length T (steps = T - 1)
    central_agent: bool
    seconds_per_time_step: float
    time_step_ratio: float
    simulate_power_outage: Tuple[bool, ...]   # per building
    # Any building uses a stochastic outage model. The signal is baked at
    # pack time for the DEFAULT episode window only (rows
    # [0, episode_steps) of the sim range; core/params.py), so batched
    # paths need data_offset == 0 or a signal rebaked by
    # core/params.rebake_outage.
    has_stochastic_outage: bool = False
    # Reference-parity mode: compute each step in float64 (like the
    # reference's Python-float arithmetic) but round to float32 exactly
    # where the reference stores into its float32 arrays (SOC,
    # energy_balance, per-device electricity_consumption, net/cost/
    # emission, demand/temperature series writes). Needs parameters packed
    # at float64 (``pack(..., param_dtype=torch.float64)``); the Gym env
    # sets it up (envs/environment.py). The whole-episode kernels refuse it.
    parity_f64: bool = False
    reward_exponent: float = 1.0
    reward_type: str = "RewardFunction"
    # ComfortReward parameters (reference reward_function.py:216-340)
    reward_band: Optional[float] = None
    reward_lower_exponent: float = 2.0
    reward_higher_exponent: float = 2.0
    reward_coefficients: Tuple[float, ...] = (1.0, 1.0)  # SolarPenaltyAndComfortReward weights
    # MultiBuildingRewardFunction (reference citylearn.py:2108-2141,
    # reward_function.py:90-118): per-building (type, exponent, band,
    # lower_exponent, higher_exponent, coefficients); None = single reward
    reward_per_building: Optional[Tuple[Tuple, ...]] = None
    # LSTM dynamics groups: per group static meta
    # (lookback, num_layers, hidden, n_channels, temp_ch, cool_ch, heat_ch)
    dyn_groups: Tuple[Tuple[int, int, int, int, int, int, int], ...] = ()
    has_dynamics: bool = False
    max_lookback: int = 0
    has_occupant: bool = False
    occupant_tree_depth: int = 0
    has_charging_constraints: bool = False
    n_charging_phases: int = 0
    charging_penalty_coefficient: float = 1.0
    any_cooling: bool = True             # any cooling demand or storage
    any_heating: bool = True
    any_dhw: bool = True
    has_evs: bool = False
    has_washing_machines: bool = False
    n_chargers: int = 0
    n_evs: int = 0
    n_washing_machines: int = 0
    # Electric_Vehicles_Reward_Function weights (reward_function.py:396-407)
    ev_reward_weights: Tuple[float, ...] = (-5.0, -2.0, -10.0, -5.0, 10.0, 5.0, 5.0)

    @property
    def any_outage(self) -> bool:
        return any(self.simulate_power_outage)


@dataclasses.dataclass
class EnvState:
    """Carried episode state. :func:`citylearn_tpu_torch.core.params.initial_state`
    gives one district (``t`` a scalar, ``(B,)`` fields); batched states
    add a leading ``D`` axis to every field."""
    t: torch.Tensor                       # int32, episode-local step index
    data_offset: torch.Tensor             # int32, episode window start in the sim range
    battery_soc: torch.Tensor             # soc[t-1] (raw, pre standby loss)
    battery_efficiency: torch.Tensor      # last applied efficiency (history[-1])
    battery_degraded_capacity: torch.Tensor
    cooling_storage_soc: torch.Tensor
    heating_storage_soc: torch.Tensor
    dhw_storage_soc: torch.Tensor
    # EV and washing-machine carry, (V,) / (V,) / (V,) / (W,) per
    # district; zero-sized when the district has none
    ev_soc: torch.Tensor                  # soc[t-1] entering the step
    ev_efficiency: torch.Tensor
    ev_degraded_capacity: torch.Tensor
    wm_initiated: torch.Tensor            # bool
    # LSTM dynamics carry per group: hidden/cell (L, Bg, H) and the
    # normalized input ring buffer (Bg, F, lookback + 1); empty tuples on
    # a district without dynamics
    lstm_h: Tuple[torch.Tensor, ...] = ()
    lstm_c: Tuple[torch.Tensor, ...] = ()
    dyn_input: Tuple[torch.Tensor, ...] = ()
    # occupant interaction carry, (B,) each per district and zero-sized
    # when the district has no occupants: NaN-coded set-point overrides,
    # the -1-coded hold counter, the previous step's predicted temperature
    # and effective set points (the decision trees' features,
    # building.py:3280-3284)
    occ_csp_override: Optional[torch.Tensor] = None
    occ_hsp_override: Optional[torch.Tensor] = None
    occ_hold_counter: Optional[torch.Tensor] = None
    occ_prev_temp: Optional[torch.Tensor] = None
    occ_prev_csp: Optional[torch.Tensor] = None
    occ_prev_hsp: Optional[torch.Tensor] = None

    def to(self, device) -> "EnvState":
        return map_tensors(lambda x: x.to(device), self)


@dataclasses.dataclass
class StepOutput:
    """Per-step results of a district batch, each ``(D, B)`` (the reward
    ``(D, 1)`` for a central agent)."""
    net_electricity_consumption: torch.Tensor
    net_electricity_consumption_cost: torch.Tensor
    net_electricity_consumption_emission: torch.Tensor
    reward: torch.Tensor
    # storage/device detail needed for counterfactual KPI baselines
    cooling_consumption: torch.Tensor
    heating_consumption: torch.Tensor
    dhw_consumption: torch.Tensor
    non_shiftable_consumption: torch.Tensor
    battery_consumption: torch.Tensor
    cooling_storage_consumption: torch.Tensor  # device input power of tank balance
    heating_storage_consumption: torch.Tensor
    dhw_storage_consumption: torch.Tensor
    solar_generation: torch.Tensor             # negative kWh
    battery_soc: torch.Tensor
    cooling_storage_soc: torch.Tensor
    heating_storage_soc: torch.Tensor
    dhw_storage_soc: torch.Tensor
    cooling_demand_met: torch.Tensor           # energy_from_cooling_device
    heating_demand_met: torch.Tensor
    dhw_demand_met: torch.Tensor
    non_shiftable_load_met: torch.Tensor
    cooling_storage_balance: torch.Tensor
    heating_storage_balance: torch.Tensor
    dhw_storage_balance: torch.Tensor
    battery_balance: torch.Tensor
    # controlled demand series (equals the data series for plain buildings,
    # partial-load demand for LSTM dynamics buildings)
    cooling_demand_actual: torch.Tensor
    heating_demand_actual: torch.Tensor
    indoor_temperature: torch.Tensor             # predicted for dynamics buildings
    cooling_set_point: torch.Tensor
    heating_set_point: torch.Tensor
    chargers_consumption: torch.Tensor           # (D, B)
    washing_machines_consumption: torch.Tensor   # (D, B)
    ev_soc: torch.Tensor                         # (D, V) soc at t after events + charges
    charging_violation_kwh: torch.Tensor         # (D, B)
    charging_building_headroom: torch.Tensor     # (D, B)
    charging_phase_headroom: torch.Tensor        # (D, P)
    # per-charger series (reference Charger.electricity_consumption /
    # past_charging_action_values_kwh, electric_vehicle_charger.py:320-328);
    # None on a district without chargers
    charger_consumption: Optional[torch.Tensor] = None          # (D, C)
    charger_action_kwh: Optional[torch.Tensor] = None           # (D, C)
