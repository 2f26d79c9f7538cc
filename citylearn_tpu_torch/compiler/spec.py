"""Resolved, static district specification (host-side, numpy).

The compiler turns ``schema.json`` + CSVs into a :class:`DistrictSpec`:
every stochastic parameter sampled, every curve resolved, every time
series loaded over the full simulation range. The spec is pure data —
the packing step (:mod:`citylearn_tpu_torch.core.params`) stacks it into
``(T, B)`` / ``(B,)`` device tensors.

Reference semantics reproduced here:
  - device parameter resolution incl. tuple sampling and default battery
    curves (``citylearn/energy_model.py:65-84,977-1003``)
  - schema loading and device construction (``citylearn/citylearn.py:1973-2409``)
  - observation/action space estimation (``citylearn/building.py:1867-2282``)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

ZERO_DIVISION_PLACEHOLDER = 1e-6  # reference citylearn/data.py:19
DEFAULT_COMFORT_BAND = 2.0        # reference citylearn/data.py:397

# Maximum number of knots any piecewise curve is padded to (the reference
# defaults have 5 and 3 points; schema-provided curves are typically <= 10).
CURVE_PAD = 12


@dataclasses.dataclass
class BatterySpec:
    """Resolved ``citylearn.energy_model.Battery`` parameters."""
    capacity: float = 0.0
    nominal_power: float = 0.0
    efficiency: float = 0.9            # base technical efficiency
    loss_coefficient: float = 0.0      # standby loss (already x time_step_ratio neutral)
    initial_soc: float = 0.0
    depth_of_discharge: float = 1.0
    capacity_loss_coefficient: float = 1e-5
    power_efficiency_curve_x: np.ndarray = None  # (CURVE_PAD,)
    power_efficiency_curve_y: np.ndarray = None
    capacity_power_curve_x: np.ndarray = None
    capacity_power_curve_y: np.ndarray = None
    # NumPy-2 scalar provenance (parity mode): a schema-literal parameter is
    # a *weak* Python float in the reference, so ``np.float32(soc) * capacity``
    # rounds to float32; an autosized/sampled parameter is a *strong*
    # np.float64 and keeps the chain in float64 (NEP 50; see core/battery.py)
    capacity_weak: bool = True
    dod_weak: bool = True


@dataclasses.dataclass
class HVACDeviceSpec:
    """HeatPump or ElectricHeater (``energy_model.py:157-451``)."""
    is_heat_pump: bool = True
    nominal_power: float = 0.0
    efficiency: float = 0.25
    target_cooling_temperature: float = 8.5
    target_heating_temperature: float = 47.5


@dataclasses.dataclass
class StorageTankSpec:
    """StorageTank (``energy_model.py:603-871``)."""
    capacity: float = 0.0
    efficiency: float = 0.94
    loss_coefficient: float = 0.005
    initial_soc: float = 0.0
    max_input_power: float = float("inf")   # inf == None in the reference
    max_output_power: float = float("inf")
    # parity-mode scalar provenance (see BatterySpec.capacity_weak):
    # ``capacity_weak`` — np.float32(soc) * capacity rounds to float32
    # (capacity is a weak Python float OR an np.float32 autosize product);
    # ``capacity_npf32`` — capacity is itself np.float32 (tank autosize:
    # np.nanmax over the float32 demand series, energy_model.py:793), so
    # ``action * capacity`` (building.py:1663) rounds to float32 too
    capacity_weak: bool = True
    capacity_npf32: bool = False


@dataclasses.dataclass
class DynamicsSpec:
    """LSTM temperature dynamics (reference ``citylearn/dynamics.py:15``),
    weights loaded offline from the dataset ``.pth``."""
    input_observation_names: List[str]
    norm_min: np.ndarray                 # (F,)
    norm_max: np.ndarray
    hidden_size: int
    num_layers: int
    lookback: int
    # torch state dict -> numpy: per layer weight_ih (4H, F|H), weight_hh
    # (4H, H), bias (4H,) = bias_ih + bias_hh; head (H,), scalar bias
    w_ih: List[np.ndarray] = dataclasses.field(default_factory=list)
    w_hh: List[np.ndarray] = dataclasses.field(default_factory=list)
    bias: List[np.ndarray] = dataclasses.field(default_factory=list)
    lin_w: np.ndarray = None
    lin_b: float = 0.0


@dataclasses.dataclass
class OccupantSpec:
    """Logistic-regression occupant thermostat interaction (reference
    ``citylearn/occupant.py:18-99``). Decision trees are flattened into
    node arrays with per-node setpoint deltas."""
    a_increase: np.ndarray = None        # (T,)
    b_increase: np.ndarray = None
    a_decrease: np.ndarray = None
    b_decrease: np.ndarray = None
    # per tree (increase, decrease): node arrays padded to max nodes
    tree_children_left: np.ndarray = None   # (2, N) int32
    tree_children_right: np.ndarray = None
    tree_feature: np.ndarray = None
    tree_threshold: np.ndarray = None       # (2, N) float32
    tree_delta: np.ndarray = None           # (2, N) float32 delta at leaves
    max_depth: int = 0
    set_point_hold_time_steps: int = 2 ** 30   # inf default


@dataclasses.dataclass
class ChargerSpec:
    """EV charger + its charger-centric schedule (reference
    ``citylearn/electric_vehicle_charger.py:10``, ``data.py:663``).
    Data arrays cover the simulation range and are indexed episode-relative
    (the reference never re-windows charger data; ``citylearn.py:2286``)."""
    charger_id: str
    building_index: int
    efficiency: float = 1.0
    max_charging_power: float = 50.0
    min_charging_power: float = 0.0
    max_discharging_power: float = 50.0
    min_discharging_power: float = 0.0
    # power-dependent efficiency curves interpolated at |action|
    # (reference electric_vehicle_charger.py:252-281); padded (CURVE_PAD,),
    # constant-at-``efficiency`` when the schema sets no curve
    charge_eff_x: np.ndarray = None
    charge_eff_y: np.ndarray = None
    discharge_eff_x: np.ndarray = None
    discharge_eff_y: np.ndarray = None
    # schedule arrays, (T,)
    state: np.ndarray = None                 # float, NaN allowed
    connected_ev: np.ndarray = None          # int32 EV index when state==1, else -1
    incoming_ev: np.ndarray = None           # int32 EV index when state==2, else -1
    capacity_kwh: np.ndarray = None
    current_soc: np.ndarray = None
    departure_time: np.ndarray = None        # int
    required_soc: np.ndarray = None
    arrival_time: np.ndarray = None          # int
    estimated_soc_arrival: np.ndarray = None


@dataclasses.dataclass
class WashingMachineSpec:
    """Deferrable-load washing machine (reference ``energy_model.py:1244``)."""
    name: str
    building_index: int
    wm_start: np.ndarray = None              # (T,) int
    wm_end: np.ndarray = None
    load_profiles: list = None               # list of np arrays per step


@dataclasses.dataclass
class ElectricVehicleSpec:
    """EV wrapping a battery (reference ``citylearn/electric_vehicle.py:12``)."""
    name: str
    index: int
    battery: "BatterySpec" = None


@dataclasses.dataclass
class BuildingSpec:
    name: str
    index: int
    active_observations: List[str]
    active_actions: List[str]
    observation_low: Dict[str, float]
    observation_high: Dict[str, float]
    action_low: List[float]
    action_high: List[float]

    battery: BatterySpec
    pv_nominal_power: float
    cooling_device: HVACDeviceSpec
    heating_device: HVACDeviceSpec
    dhw_device: HVACDeviceSpec
    cooling_storage: StorageTankSpec
    heating_storage: StorageTankSpec
    dhw_storage: StorageTankSpec

    # Full-simulation-range input series, each (T,) float32 (ints int32).
    series: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    simulate_power_outage: bool = False
    stochastic_power_outage: bool = False
    stochastic_power_outage_model: Optional[dict] = None
    dynamics: Optional[DynamicsSpec] = None
    occupant: Optional["OccupantSpec"] = None
    chargers: List["ChargerSpec"] = dataclasses.field(default_factory=list)
    washing_machines: List["WashingMachineSpec"] = dataclasses.field(default_factory=list)
    charging_constraints: Optional[dict] = None


@dataclasses.dataclass
class DistrictSpec:
    schema: dict
    dataset_dir: str
    buildings: List[BuildingSpec]
    central_agent: bool
    random_seed: int
    seconds_per_time_step: float
    time_step_ratio: float
    simulation_start_time_step: int
    simulation_end_time_step: int
    episode_time_steps: Optional[object]   # int | list[[start, end]] | None
    rolling_episode_split: bool
    random_episode_split: bool
    shared_observations: List[str]
    electric_vehicles: List["ElectricVehicleSpec"] = dataclasses.field(default_factory=list)

    @property
    def simulation_time_steps(self) -> int:
        return self.simulation_end_time_step - self.simulation_start_time_step + 1

    @property
    def n_buildings(self) -> int:
        return len(self.buildings)

    def observation_names(self) -> List[List[str]]:
        """Per-agent observation name lists (reference ``citylearn.py:487-514``)."""
        if self.central_agent:
            names, seen_shared = [], []
            for i, b in enumerate(self.buildings):
                for k in b.active_observations:
                    if i == 0 or k not in self.shared_observations or k not in names:
                        names.append(k)
            return [names]
        return [list(b.active_observations) for b in self.buildings]

    def action_names(self) -> List[List[str]]:
        if self.central_agent:
            return [[a for b in self.buildings for a in b.active_actions]]
        return [list(b.active_actions) for b in self.buildings]
