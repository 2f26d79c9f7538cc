"""Single-district Gymnasium adapter: a drop-in for
``citylearn.citylearn.CityLearnEnv`` on the port's district step.

Reproduces the reference's external contract:
  - observation/action ordering and spaces (``citylearn.py:385-538``);
  - the returned observation at t+1 reads *unwritten* state-derived values
    (SOC, net consumption, device consumption = 0) while data-driven values
    come from index t+1 — the shipped semantics agents actually see
    (``building.py:1115-1219`` over zero-filled arrays);
  - reset-time observations reflect the reset ``update_variables`` pass
    (``citylearn.py:1884``, ``building.py:2615-2652``);
  - ``terminated`` at ``time_step == time_steps - 1`` (``citylearn.py:373``);
  - ``evaluate()`` KPI DataFrame with control/baseline normalization
    (``citylearn.py:1136-1323``).

Each step is one :func:`~citylearn_tpu_torch.core.step.district_step` of
a batch of one district on the env's device (the CUDA card unless the
caller passes ``device="cpu"``; there one replay of the env's CUDA graph
of the step and its packing, :mod:`citylearn_tpu_torch.core.step_graph`):
the actions go over in one host-to-device copy, and every per-building
series the env keeps, the reward and the step's extras (charger series,
EV SOCs, charging headrooms, occupant set-point overrides) come back in
ONE device-to-host copy. Observations,
history and KPIs are then built on the host in numpy. ``pandas`` (the
``evaluate()`` frame) is imported only where it is used, and the spaces are
gymnasium's where it imports and the port's :class:`~citylearn_tpu_torch.spaces.Box`
where it does not: without either the env resets, steps, scores
(:meth:`CityLearnEnv.evaluate_rows`) and serves the agents.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device, tracing
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.compiler.spaces import _hvac_input_power_np
from citylearn_tpu_torch.compiler.spec import DistrictSpec
from citylearn_tpu_torch.core import kpi
from citylearn_tpu_torch.core.params import initial_state, lift_f64, pack
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.step_graph import StepGraph, engaged_graph
from citylearn_tpu_torch.core.types import DistrictParams, EnvState, StaticConfig, map_tensors
from citylearn_tpu_torch.envs.episode import EpisodeTracker
from citylearn_tpu_torch.envs.outage import building_outage_signal
from citylearn_tpu_torch.envs.views import BuildingView, _condition_value
from citylearn_tpu_torch.spaces import box

STORAGE_ACTIONS = ("cooling_storage", "heating_storage", "dhw_storage",
                   "electrical_storage")
DEVICE_ACTIONS = ("cooling_device", "heating_device", "cooling_or_heating_device")

# (history key, StepOutput field): the per-building series the Gym adapter
# keeps each step, stacked on the device so that the host pays a single
# transfer per step
_HIST_FIELDS = (
    ("net", "net_electricity_consumption"),
    ("cost", "net_electricity_consumption_cost"),
    ("emission", "net_electricity_consumption_emission"),
    ("cooling_storage_cons", "cooling_storage_consumption"),
    ("heating_storage_cons", "heating_storage_consumption"),
    ("dhw_storage_cons", "dhw_storage_consumption"),
    ("battery_cons", "battery_consumption"),
    ("solar", "solar_generation"),
    ("cooling_demand_met", "cooling_demand_met"),
    ("heating_demand_met", "heating_demand_met"),
    ("dhw_demand_met", "dhw_demand_met"),
    ("non_shiftable_load_met", "non_shiftable_load_met"),
    ("cooling_storage_balance", "cooling_storage_balance"),
    ("heating_storage_balance", "heating_storage_balance"),
    ("dhw_storage_balance", "dhw_storage_balance"),
    ("battery_soc", "battery_soc"),
    ("battery_balance", "battery_balance"),
    ("indoor_temperature", "indoor_temperature"),
    ("cooling_demand_actual", "cooling_demand_actual"),
    ("heating_demand_actual", "heating_demand_actual"),
    ("chargers_cons", "chargers_consumption"),
    ("wm_cons", "washing_machines_consumption"),
    ("cooling_sp", "cooling_set_point"),
    ("heating_sp", "heating_set_point"),
    ("cooling_cons", "cooling_consumption"),
    ("heating_cons", "heating_consumption"),
    ("dhw_cons", "dhw_consumption"),
    ("nsl_cons", "non_shiftable_consumption"),
    ("cooling_storage_soc", "cooling_storage_soc"),
    ("heating_storage_soc", "heating_storage_soc"),
    ("dhw_storage_soc", "dhw_storage_soc"),
)

#: the columns of :meth:`CityLearnEnv.evaluate`'s frame
KPI_COLUMNS = ("cost_function", "value", "name", "level")


def _extras(cfg: StaticConfig) -> Tuple[Tuple[str, int], ...]:
    """(name, length) of what the step's host copy carries after the
    history block, in order."""
    out = [("reward", 1 if cfg.central_agent else cfg.n_buildings)]
    if cfg.has_evs:
        out += [("charger_cons", cfg.n_chargers), ("charger_action_kwh", cfg.n_chargers),
                ("ev_soc", cfg.n_evs)]
    if cfg.has_charging_constraints:
        out += [("cc_building", cfg.n_buildings), ("cc_phase", cfg.n_charging_phases),
                ("cc_violation", cfg.n_buildings)]
    if cfg.has_occupant:
        out += [("occ_csp_override", cfg.n_buildings), ("occ_hsp_override", cfg.n_buildings)]
    return tuple(out)


def step_packed(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                actions: Dict[str, torch.Tensor]) -> Tuple[EnvState, torch.Tensor]:
    """One district step of a batch of one, and everything the env keeps
    from it in one flat tensor: the ``_HIST_FIELDS`` rows (K, B), then
    :func:`_extras` in order. Float64 in the parity mode, else float32.
    Inside a :meth:`~citylearn_tpu_torch.core.step_graph.StepGraph.engaged`
    block the step and the packing are one replay of that graph, and the
    state and the flat tensor are its static outputs."""
    with tracing.span("env.district_step"), torch.inference_mode():
        graph = engaged_graph()
        if graph is not None:
            return graph.run(_packed_step, cfg, params, state, actions)
        return _packed_step(cfg, params, state, actions)


def _packed_step(cfg: StaticConfig, params: DistrictParams, state: EnvState,
                 actions: Dict[str, torch.Tensor]) -> Tuple[EnvState, torch.Tensor]:
    dtype = torch.float64 if cfg.parity_f64 else torch.float32
    st, out = district_step(cfg, params, state, actions)
    parts = [getattr(out, f) for _, f in _HIST_FIELDS] + [out.reward]
    if cfg.has_evs:
        parts += [out.charger_consumption, out.charger_action_kwh, out.ev_soc]
    if cfg.has_charging_constraints:
        parts += [out.charging_building_headroom, out.charging_phase_headroom,
                  out.charging_violation_kwh]
    if cfg.has_occupant:
        parts += [st.occ_csp_override, st.occ_hsp_override]
    return st, torch.cat([p.reshape(-1).to(dtype) for p in parts])


class CityLearnEnv:
    """CityLearn environment of one district on the port's step."""

    def __init__(self, schema: Union[str, dict], root_directory: str = None,
                 central_agent: bool = None, episode_time_steps=None,
                 rolling_episode_split: bool = None, random_episode_split: bool = None,
                 simulation_start_time_step: int = None,
                 simulation_end_time_step: int = None, random_seed: int = None,
                 reward_function: str = None, solar_generation=None,
                 render: bool = None, render_mode: str = None,
                 render_directory: str = None, render_session_name: str = None,
                 start_date: str = None, device=None, **kwargs: Any):
        # Parity mode: float64 step arithmetic with float32 rounding at the
        # reference's array-store points — tracks the reference's
        # Python-float-over-float32-arrays trajectory to ~1 float32 ulp.
        # Off by default (the all-float32 path).
        self.parity_f64 = bool(kwargs.pop("parity_f64", False))
        self.device = resolve_device(device)
        if isinstance(schema, str) and not os.path.exists(schema):
            # a named dataset (reference citylearn.py:863-884)
            from citylearn_tpu_torch.data import DataSet
            schema = DataSet().get_schema_path(schema)
        self.spec: DistrictSpec = compile_schema(
            schema, root_directory=root_directory, central_agent=central_agent,
            episode_time_steps=episode_time_steps,
            rolling_episode_split=rolling_episode_split,
            random_episode_split=random_episode_split,
            simulation_start_time_step=simulation_start_time_step,
            simulation_end_time_step=simulation_end_time_step,
            random_seed=random_seed, solar_generation=solar_generation,
            # remaining constructor overrides (active/inactive observation
            # and action lists etc., reference citylearn.py:138-201) pass
            # straight through to the compiler
            **kwargs)
        # parity mode packs the device parameters at float64 (they are
        # Python floats in the reference — schema JSON values — so float32
        # packing would perturb every energy conversion by ~1e-8 relative
        # and flip occasional float32 store ulps) and lifts the float32 data
        # series too (lossless: the reference's data arrays ARE float32);
        # the LSTM groups stay float32 like the reference's torch models
        self.cfg, self.params, self.layout = pack(
            self.spec, device=self.device,
            param_dtype=torch.float64 if self.parity_f64 else torch.float32)
        if reward_function is not None:
            # the constructor override replaces the schema's reward entirely
            # (reference citylearn.py:2145-2152), including a per-building
            # reward dict -> the dict dispatch must be cleared too
            self.cfg = dataclasses.replace(self.cfg, reward_type=reward_function,
                                           reward_per_building=None)
        self._extras = _extras(self.cfg)
        self._action_keys = STORAGE_ACTIONS + DEVICE_ACTIONS + (
            ("electric_vehicle_storage",) if self.cfg.has_evs else ()) + (
            ("washing_machine",) if self.cfg.has_washing_machines else ())
        self.episode_tracker = EpisodeTracker(
            self.spec.simulation_start_time_step, self.spec.simulation_end_time_step)
        # host copies made once: the data-driven observation matrix and the
        # charging limits (the reset values of the headrooms)
        self._obs_static_np = self.params.obs_static.cpu().numpy()
        if self.cfg.has_charging_constraints:
            self._cc_limits = (self.params.chargers.cc_building_limit.cpu().numpy(),
                               self.params.chargers.cc_phase_limit.cpu().numpy())
        self._rewards: List[List[float]] = [[]]
        self._episode_rewards: List[dict] = []
        self._history: dict = {}
        self._state = None
        # this env's CUDA graph of step_packed (core/step_graph.py)
        self._step_graph = StepGraph()
        schema_dict = self.spec.schema
        self.render_enabled = bool(schema_dict.get("render", False)
                                   if render is None else render)
        self.render_mode = render_mode or schema_dict.get("render_mode") or "during"
        self._renderer = None
        if self.render_enabled:
            from citylearn_tpu_torch.envs.render import CSVRenderer
            self._renderer = CSVRenderer(
                self, directory=render_directory or "render_exports",
                session_name=render_session_name
                or schema_dict.get("render_session_name"),
                mode=self.render_mode,
                start_date=start_date or schema_dict.get("start_date"))
        self.reset()
        # The reference resets the episode index after its construction-time
        # reset so the user's first reset() replays episode 0
        # (citylearn.py:237 + base.py:131-134 semantics observed empirically).
        self.episode_tracker.episode = -1

    # ------------------------------------------------------------------
    # surface properties (reference citylearn.py:360-538)
    # ------------------------------------------------------------------
    @property
    def central_agent(self) -> bool:
        return self.spec.central_agent

    @property
    def buildings(self) -> List[BuildingView]:
        """Live building views (drop-ins for ``citylearn.building.Building``)
        reading per-episode series from the step's history arrays."""
        if getattr(self, "_building_views", None) is None:
            self._building_views = [BuildingView(self, bi, b)
                                    for bi, b in enumerate(self.spec.buildings)]
        return self._building_views

    # ------------------------------------------------------------------
    # district-level series (reference citylearn.py:645-960)
    # ------------------------------------------------------------------
    def _district_sum(self, condition: str) -> np.ndarray:
        return np.sum([self._building_series(bi, condition)[0]
                       for bi in range(self.cfg.n_buildings)], axis=0)

    @property
    def net_electricity_consumption(self) -> np.ndarray:
        self._sync_unwritten_row()
        return self._history["net"][: self._t + 1].sum(axis=1)

    @property
    def net_electricity_consumption_cost(self) -> np.ndarray:
        self._sync_unwritten_row()
        return self._history["cost"][: self._t + 1].sum(axis=1)

    @property
    def net_electricity_consumption_emission(self) -> np.ndarray:
        self._sync_unwritten_row()
        return self._history["emission"][: self._t + 1].sum(axis=1)

    @property
    def net_electricity_consumption_without_storage(self) -> np.ndarray:
        return self._district_sum("_without_storage")

    @property
    def net_electricity_consumption_without_storage_and_pv(self) -> np.ndarray:
        return self._district_sum("_without_storage_and_pv")

    @property
    def net_electricity_consumption_without_storage_and_partial_load(self) -> np.ndarray:
        return self._district_sum("_without_storage_and_partial_load")

    @property
    def net_electricity_consumption_without_storage_and_partial_load_and_pv(self) -> np.ndarray:
        return self._district_sum("_without_storage_and_partial_load_and_pv")

    def load_agent(self, agent=None, **kwargs):
        """Instantiate the schema-defined (or given) agent on this env
        (reference ``citylearn.py:1920-1971``). ``agent`` may be a class, a
        dotted path (``citylearn.agents.*`` and ``citylearn_tpu.agents.*``
        resolve to the port's agents) or None for the schema's ``agent``
        block."""
        from citylearn_tpu_torch.cli import DEFAULT_AGENT, resolve_class
        attributes = dict(kwargs)
        if agent is None:
            block = (self.spec.schema or {}).get("agent") or {}
            agent_type = block.get("type", DEFAULT_AGENT)
            attrs = dict(block.get("attributes") or {})
            attrs.update(attributes)
            attributes = attrs
        elif isinstance(agent, str):
            agent_type = agent
        else:
            agent_type = f"{agent.__module__}.{agent.__name__}"
        return resolve_class(agent_type)(self, **attributes)

    @property
    def time_step(self) -> int:
        return self._t

    @property
    def time_steps(self) -> int:
        return self.episode_tracker.episode_time_steps

    @property
    def terminated(self) -> bool:
        return self._t == self.time_steps - 1

    @property
    def truncated(self) -> bool:
        return False

    @property
    def rewards(self) -> List[List[float]]:
        return self._rewards

    @property
    def episode_rewards(self) -> List[dict]:
        return self._episode_rewards

    @property
    def observation_names(self) -> List[List[str]]:
        return self.spec.observation_names()

    @property
    def action_names(self) -> List[List[str]]:
        return self.spec.action_names()

    @property
    def shared_observations(self) -> List[str]:
        return self.spec.shared_observations

    @property
    def observation_space(self):
        lows, highs = [], []
        for b in self.spec.buildings:
            lows.append(np.array([b.observation_low[k] for k in b.active_observations],
                                 dtype=np.float32))
            highs.append(np.array([b.observation_high[k] for k in b.active_observations],
                                  dtype=np.float32))
        if self.central_agent:
            return [box(*self._dedup_central(lows, highs))]
        return [box(l, h) for l, h in zip(lows, highs)]

    @property
    def action_space(self):
        if self.central_agent:
            lo = np.concatenate([np.asarray(b.action_low, np.float32)
                                 for b in self.spec.buildings])
            hi = np.concatenate([np.asarray(b.action_high, np.float32)
                                 for b in self.spec.buildings])
            return [box(lo, hi)]
        return [box(np.asarray(b.action_low, np.float32), np.asarray(b.action_high, np.float32))
                for b in self.spec.buildings]

    def _dedup_central(self, lows, highs):
        """Shared observations appear once, at their first occurrence
        (reference citylearn.py:400-420)."""
        out_lo, out_hi, seen_shared = [], [], []
        for i, b in enumerate(self.spec.buildings):
            for l, h, name in zip(lows[i], highs[i], b.active_observations):
                if i == 0 or name not in self.spec.shared_observations \
                        or name not in seen_shared:
                    out_lo.append(l)
                    out_hi.append(h)
                if name in self.spec.shared_observations and name not in seen_shared:
                    seen_shared.append(name)
        return np.asarray(out_lo, np.float32), np.asarray(out_hi, np.float32)

    # ------------------------------------------------------------------
    # reset / step
    # ------------------------------------------------------------------
    def reset(self, seed: int = None, options: Mapping[str, Any] = None
              ) -> Tuple[List[List[float]], dict]:
        if seed is not None:
            self.spec.random_seed = seed
        self.episode_tracker.next_episode(
            self.spec.episode_time_steps, self.spec.rolling_episode_split,
            self.spec.random_episode_split, self.spec.random_seed)
        self._offset = (self.episode_tracker.episode_start_time_step
                        - self.spec.simulation_start_time_step)
        self._t = 0
        self._refresh_outage_signals()
        state = initial_state(self.cfg, self.params, self._offset)
        if self.parity_f64:
            # lift the float32-pinned state fields (occupant prevs, EV
            # zero-cases); LSTM carries stay float32 like the reference
            lstm = dict(lstm_h=state.lstm_h, lstm_c=state.lstm_c, dyn_input=state.dyn_input)
            state = dataclasses.replace(lift_f64(dataclasses.replace(
                state, lstm_h=(), lstm_c=(), dyn_input=())), **lstm)
        self._state = map_tensors(lambda x: x.unsqueeze(0), state)   # a batch of one
        self._rewards = [[]]
        T = self.time_steps
        B = self.cfg.n_buildings
        # one (T, K, B) buffer; the history dict holds VIEWS into it so the
        # step writes one row with a single assignment while every reader
        # keeps the by-name interface
        self._hist_buf = np.zeros((T, len(_HIST_FIELDS), B), np.float32)
        self._history = {k: self._hist_buf[:, i]
                         for i, (k, _) in enumerate(_HIST_FIELDS)}
        if self.cfg.has_evs:
            # per-charger series (reference Charger.reset zeros them,
            # electric_vehicle_charger.py:344-349)
            C = self.cfg.n_chargers
            self._history["charger_cons"] = np.zeros((T, C), np.float32)
            self._history["charger_action_kwh"] = np.zeros((T, C), np.float32)
            self._ev_soc = state.ev_soc.cpu().numpy()
        # the occupant set-point overrides after the last step (NaN: none)
        self._occ_override = np.full((2, B), np.nan)
        self._synced_t = 0
        self._write_reset_row()
        if self.cfg.has_charging_constraints:
            # reference reset defaults: headroom = limits, violation 0
            # (building.py:886-899)
            self._cc_last = {
                "building": self._cc_limits[0],
                "phase": self._cc_limits[1],
                "violation": np.zeros(self.cfg.n_buildings, np.float32),
            }
            if not hasattr(self, "_cc_phase_names"):
                names, pid = {}, 0
                for b in self.spec.buildings:
                    for phase in ((b.charging_constraints or {}).get("phases") or []):
                        names[(b.index, phase.get("name"))] = pid
                        pid += 1
                self._cc_phase_names = names
        return self.observations, self.get_info()

    def _refresh_outage_signals(self):
        """Resolve per-episode outage signals (stochastic models re-sample
        per reset in the reference, building.py:2566-2594 — with a fresh
        RandomState(seed) each time, so the signal is identical every
        episode) and bake them into the device-resident series."""
        T_ep = self.episode_tracker.episode_time_steps
        B = self.cfg.n_buildings
        ep_slice = slice(self.episode_tracker.episode_start_time_step,
                         self.episode_tracker.episode_end_time_step + 1)
        self._outage_np = np.zeros((T_ep, B), np.float32)
        for bi, b in enumerate(self.spec.buildings):
            self._outage_np[:, bi] = building_outage_signal(
                b, T_ep, self.spec.seconds_per_time_step, ep_slice)
        if not any(b.simulate_power_outage and b.stochastic_power_outage
                   for b in self.spec.buildings):
            return
        T_sim = self.spec.simulation_time_steps
        full = np.zeros((T_sim, B), np.float64 if self.parity_f64 else np.float32)
        full[self._offset:self._offset + T_ep] = self._outage_np
        self.params = dataclasses.replace(self.params, series=dataclasses.replace(
            self.params.series, power_outage=torch.as_tensor(full, device=self.device)))

    def _reset_consumptions(self, idx: int):
        """Reset-time ``update_variables`` values at absolute sim index
        ``idx`` (building.py:2615-2652 with prefilled demand arrays)."""
        cools, heats, dhws, nsls, nets = [], [], [], [], []
        for b in self.spec.buildings:
            t_out = b.series["outdoor_dry_bulb_temperature"][idx]
            cool = float(_hvac_input_power_np(b.cooling_device,
                                              b.series["cooling_demand"][idx], t_out, False))
            if b.heating_device.is_heat_pump:
                heat = float(_hvac_input_power_np(b.heating_device,
                                                  b.series["heating_demand"][idx], t_out, True))
            else:
                heat = float(b.series["heating_demand"][idx] / b.dhw_device.efficiency)
            dhw = float(_hvac_input_power_np(b.dhw_device,
                                             b.series["dhw_demand"][idx], t_out, True))
            nsl = float(b.series["non_shiftable_load"][idx])
            solar = -b.pv_nominal_power * float(b.series["solar_generation"][idx]) / 1000.0
            bi = b.index
            outage = self._outage_np[0, bi] > 0
            net = 0.0 if outage else cool + heat + dhw + nsl + solar
            cools.append(cool); heats.append(heat); dhws.append(dhw)
            nsls.append(nsl); nets.append(net)
        return cools, heats, dhws, nsls, nets

    def _write_reset_row(self):
        idx = self.episode_tracker.episode_start_time_step
        cools, heats, dhws, nsls, nets = self._reset_consumptions(idx)
        h = self._history
        for bi, b in enumerate(self.spec.buildings):
            h["net"][0, bi] = nets[bi]
            h["cost"][0, bi] = nets[bi] * b.series["electricity_pricing"][idx]
            h["emission"][0, bi] = max(0.0, nets[bi] * b.series["carbon_intensity"][idx])
            h["solar"][0, bi] = -b.pv_nominal_power * b.series["solar_generation"][idx] / 1000.0
            h["cooling_demand_met"][0, bi] = b.series["cooling_demand"][idx]
            h["heating_demand_met"][0, bi] = b.series["heating_demand"][idx]
            h["dhw_demand_met"][0, bi] = b.series["dhw_demand"][idx]
            h["non_shiftable_load_met"][0, bi] = b.series["non_shiftable_load"][idx]
            h["battery_soc"][0, bi] = b.battery.initial_soc
            h["cooling_storage_soc"][0, bi] = b.cooling_storage.initial_soc
            h["heating_storage_soc"][0, bi] = b.heating_storage.initial_soc
            h["dhw_storage_soc"][0, bi] = b.dhw_storage.initial_soc
            h["cooling_cons"][0, bi] = cools[bi]
            h["heating_cons"][0, bi] = heats[bi]
            h["dhw_cons"][0, bi] = dhws[bi]
            h["nsl_cons"][0, bi] = nsls[bi]
            h["indoor_temperature"][0, bi] = b.series["indoor_dry_bulb_temperature"][idx]
            h["cooling_demand_actual"][0, bi] = b.series["cooling_demand"][idx]
            h["heating_demand_actual"][0, bi] = b.series["heating_demand"][idx]
            h["cooling_sp"][0, bi] = \
                b.series["indoor_dry_bulb_temperature_cooling_set_point"][idx]
            h["heating_sp"][0, bi] = \
                b.series["indoor_dry_bulb_temperature_heating_set_point"][idx]

    @property
    def _charger_action_slots(self):
        if not hasattr(self, "_charger_slots_cache"):
            slots = {}
            c = 0
            for b in self.spec.buildings:
                for ch in b.chargers:
                    slots[f"electric_vehicle_storage_{ch.charger_id}"] = c
                    c += 1
            wslots = {}
            w = 0
            for b in self.spec.buildings:
                for wm in b.washing_machines:
                    wslots[wm.name] = w
                    w += 1
            self._charger_slots_cache = (slots, wslots)
        return self._charger_slots_cache

    def _parse_actions(self, actions) -> dict:
        """Flat agent action lists -> name -> (B,)/(C,)/(W,) arrays
        (reference citylearn.py:1063-1134)."""
        B = self.cfg.n_buildings
        # parity mode keeps agent actions at float64 like the reference's
        # Python floats; the fast path rounds them to float32
        adt = np.float64 if self.parity_f64 else np.float32
        out = {k: np.zeros(B, adt) for k in STORAGE_ACTIONS + DEVICE_ACTIONS}
        ch_slots, wm_slots = self._charger_action_slots
        if self.cfg.has_evs:
            out["electric_vehicle_storage"] = np.zeros(self.cfg.n_chargers, adt)
        if self.cfg.has_washing_machines:
            out["washing_machine"] = np.zeros(self.cfg.n_washing_machines, adt)
        if self.central_agent:
            flat = list(np.asarray(actions[0]).ravel())
            per_building = []
            for b in self.spec.buildings:
                n = len(b.active_actions)
                per_building.append(flat[:n])
                flat = flat[n:]
            if flat:
                raise ValueError("too many actions for central agent")
        else:
            per_building = [list(np.asarray(a).ravel()) for a in actions]
        for bi, (b, acts) in enumerate(zip(self.spec.buildings, per_building)):
            if len(acts) != len(b.active_actions):
                raise ValueError(
                    f"expected {len(b.active_actions)} actions for {b.name}, got {len(acts)}")
            for name, val in zip(b.active_actions, acts):
                if name in ch_slots:
                    out["electric_vehicle_storage"][ch_slots[name]] = val
                elif name in wm_slots:
                    out["washing_machine"][wm_slots[name]] = val
                else:
                    out[name][bi] = val
        return out

    def _device_actions(self, acts: dict) -> Dict[str, torch.Tensor]:
        """The parsed actions on the env's device in one copy, as views of
        shape (1, n) (a batch of one district)."""
        flat = torch.from_numpy(np.concatenate([acts[k] for k in self._action_keys]))
        flat = flat.to(self.device)
        out, at = {}, 0
        for k in self._action_keys:
            n = len(acts[k])
            out[k] = flat[at:at + n][None]
            at += n
        return out

    @tracing.traced("env.step")
    def step(self, actions) -> Tuple[List[List[float]], List[float], bool, bool, dict]:
        with tracing.span("env.actions"):
            acts = self._device_actions(self._parse_actions(actions))
        with self._step_graph.engaged():
            self._state, flat = step_packed(self.cfg, self.params, self._state, acts)
        with tracing.span("env.readback"):
            flat = flat.cpu().numpy()               # the step's one device-to-host copy
        return self._observe(flat)

    @tracing.traced("env.observe")
    def _observe(self, flat: np.ndarray) -> Tuple[List[List[float]], List[float], bool, bool, dict]:
        """The step's history row, extras and rewards from its copied
        ``step_packed`` output; returns what ``step`` returns."""
        t = self._t
        K, B = len(_HIST_FIELDS), self.cfg.n_buildings
        self._hist_buf[t] = flat[:K * B].reshape(K, B)
        extras, at = {}, K * B
        for name, n in self._extras:
            extras[name] = flat[at:at + n]
            at += n
        h = self._history
        if self.cfg.has_evs:
            h["charger_cons"][t] = extras["charger_cons"]
            h["charger_action_kwh"][t] = extras["charger_action_kwh"]
            self._ev_soc = extras["ev_soc"]
        if self.cfg.has_charging_constraints:
            self._cc_last = {
                "building": extras["cc_building"],
                "phase": extras["cc_phase"],
                "violation": extras["cc_violation"],
            }
        if self.cfg.has_occupant:
            self._occ_override = np.stack([extras["occ_csp_override"],
                                           extras["occ_hsp_override"]])

        reward = [float(r) for r in extras["reward"]]
        self._rewards.append(reward)
        self._t += 1
        self._synced_t = -1  # current row is now unwritten

        if self._renderer is not None:
            self._renderer.render()

        if self.terminated:
            r = np.array(self._rewards[1:], dtype=np.float32)
            self._episode_rewards.append({
                "min": r.min(axis=0).tolist(), "max": r.max(axis=0).tolist(),
                "sum": r.sum(axis=0).tolist(), "mean": r.mean(axis=0).tolist()})
            if self._renderer is not None:
                self._renderer.flush()
                self._renderer.export_final_kpis()

        return self.observations, reward, self.terminated, self.truncated, self.get_info()

    def get_info(self) -> Mapping[Any, Any]:
        return {}

    def get_metadata(self) -> Mapping[str, Any]:
        """Static env metadata (reference ``citylearn.py:940-954`` +
        ``building.py:1080-1113``): annual demand/generation estimates over
        the current episode window plus device/storage summaries."""
        ep = self.episode_tracker
        sl = slice(ep.episode_start_time_step, ep.episode_end_time_step + 1)
        n_years = max(1.0, (ep.episode_time_steps * self.spec.seconds_per_time_step)
                      / (8760 * 3600))
        buildings = []
        for b in self.spec.buildings:
            buildings.append({
                "name": b.name,
                "annual_cooling_demand_estimate": float(b.series["cooling_demand"][sl].sum()) / n_years,
                "annual_heating_demand_estimate": float(b.series["heating_demand"][sl].sum()) / n_years,
                "annual_dhw_demand_estimate": float(b.series["dhw_demand"][sl].sum()) / n_years,
                "annual_non_shiftable_load_estimate": float(b.series["non_shiftable_load"][sl].sum()) / n_years,
                "annual_solar_generation_estimate":
                    float((b.pv_nominal_power * b.series["solar_generation"][sl] / 1000.0).sum()) / n_years,
                "cooling_storage": {"capacity": b.cooling_storage.capacity},
                "heating_storage": {"capacity": b.heating_storage.capacity},
                "dhw_storage": {"capacity": b.dhw_storage.capacity},
                "electrical_storage": {"capacity": b.battery.capacity,
                                       "nominal_power": b.battery.nominal_power},
                "pv": {"nominal_power": b.pv_nominal_power},
                "observation_metadata": {k: True for k in b.active_observations},
                "action_metadata": {k: True for k in b.active_actions},
            })
        return {
            "central_agent": self.central_agent,
            "random_seed": self.spec.random_seed,
            "seconds_per_time_step": self.spec.seconds_per_time_step,
            "simulation_time_steps": self.spec.simulation_time_steps,
            "buildings": buildings,
        }

    # ------------------------------------------------------------------
    # observations
    # ------------------------------------------------------------------
    @property
    def observations(self) -> List[List[float]]:
        """Observations at the current time step (reference
        citylearn.py:451-485 semantics, including stale derived values)."""
        per_building = self._building_observations()
        if not self.central_agent:
            return per_building
        merged, seen_shared = [], []
        for bi, b in enumerate(self.spec.buildings):
            for name, v in zip(b.active_observations, per_building[bi]):
                if bi == 0 or name not in self.spec.shared_observations \
                        or name not in seen_shared:
                    merged.append(v)
                if name in self.spec.shared_observations and name not in seen_shared:
                    seen_shared.append(name)
        return [merged]

    def _building_observations(self) -> List[List[float]]:
        """Per-building observation value lists at the current step."""
        idx = self._offset + self._t
        row = self._obs_static_np[idx]  # (B, K)
        per_building = []
        for bi, b in enumerate(self.spec.buildings):
            cols = self.layout.building_indices[bi]
            vals = row[bi, list(cols)].astype(np.float64)
            if b.simulate_power_outage and b.stochastic_power_outage \
                    and "power_outage" in b.active_observations:
                vals[b.active_observations.index("power_outage")] = \
                    self._outage_np[self._t, bi]
            if self.cfg.has_occupant:
                # occupant-mutated setpoint series affect the returned
                # setpoint/delta observations (building.py:3295-3307)
                ov_c, ov_h = (float(v) for v in self._occ_override[:, bi])
                names = b.active_observations
                idt = b.series["indoor_dry_bulb_temperature"][idx + self.spec.simulation_start_time_step]
                for ov, sp_name, d_name in (
                        (ov_c, "indoor_dry_bulb_temperature_cooling_set_point",
                         "indoor_dry_bulb_temperature_cooling_delta"),
                        (ov_h, "indoor_dry_bulb_temperature_heating_set_point",
                         "indoor_dry_bulb_temperature_heating_delta")):
                    if np.isfinite(ov):
                        if sp_name in names:
                            vals[names.index(sp_name)] = ov
                        if d_name in names:
                            vals[names.index(d_name)] = idt - ov
            if self.cfg.has_charging_constraints and b.charging_constraints:
                names = b.active_observations
                for i, name in enumerate(names):
                    if name == "charging_building_headroom_kw":
                        vals[i] = self._cc_last["building"][bi]
                    elif name == "charging_constraint_violation_kwh":
                        vals[i] = self._cc_last["violation"][bi]
                    elif name.startswith("charging_phase_") \
                            and name.endswith("_headroom_kw"):
                        pn = name[len("charging_phase_"):-len("_headroom_kw")]
                        pid = self._cc_phase_names.get((bi, pn))
                        if pid is not None:
                            vals[i] = self._cc_last["phase"][pid]
            if self._t == 0:
                vals = self._apply_reset_corrections(bi, vals)
            per_building.append(list(vals))
        return per_building

    def _apply_reset_corrections(self, bi: int, vals: np.ndarray) -> np.ndarray:
        """At reset, index 0 *has* been written by the reset-time
        ``update_variables`` and SOC[0] = initial_soc."""
        b = self.spec.buildings[bi]
        cools, heats, dhws, nsls, nets = self._reset_cache
        corrections = {
            "electrical_storage_soc": b.battery.initial_soc,
            "cooling_storage_soc": b.cooling_storage.initial_soc,
            "heating_storage_soc": b.heating_storage.initial_soc,
            "dhw_storage_soc": b.dhw_storage.initial_soc,
            "net_electricity_consumption": nets[bi],
            "cooling_electricity_consumption": cools[bi],
            "heating_electricity_consumption": heats[bi],
            "dhw_electricity_consumption": dhws[bi],
        }
        for i, name in enumerate(b.active_observations):
            if name in corrections:
                vals[i] = corrections[name]
        return vals

    @property
    def _reset_cache(self):
        if not hasattr(self, "_reset_cache_val") or self._reset_cache_idx != \
                self.episode_tracker.episode_start_time_step:
            self._reset_cache_idx = self.episode_tracker.episode_start_time_step
            self._reset_cache_val = self._reset_consumptions(self._reset_cache_idx)
        return self._reset_cache_val

    # ------------------------------------------------------------------
    # evaluation (reference citylearn.py:1136-1323)
    # ------------------------------------------------------------------
    def _sync_unwritten_row(self):
        """Index ``self._t`` has not been written by a step yet (the
        reference's ``energy_from_*`` arrays are *prefilled* with the raw
        demand series at reset, ``building.py:2554-2558``, so the un-stepped
        row reads as demand fully met with zero storage activity). Patch it,
        except at t == 0 where the reset row already holds the correct
        values."""
        if self._synced_t == self._t or self._t < 1:
            self._synced_t = self._t
            return
        h = self._history
        idx = self.episode_tracker.episode_start_time_step + self._t
        for bi, b in enumerate(self.spec.buildings):
            h["cooling_demand_met"][self._t, bi] = b.series["cooling_demand"][idx]
            h["heating_demand_met"][self._t, bi] = b.series["heating_demand"][idx]
            h["dhw_demand_met"][self._t, bi] = b.series["dhw_demand"][idx]
            h["non_shiftable_load_met"][self._t, bi] = b.series["non_shiftable_load"][idx]
            h["indoor_temperature"][self._t, bi] = \
                b.series["indoor_dry_bulb_temperature"][idx]
            h["cooling_demand_actual"][self._t, bi] = b.series["cooling_demand"][idx]
            h["heating_demand_actual"][self._t, bi] = b.series["heating_demand"][idx]
            csp = b.series["indoor_dry_bulb_temperature_cooling_set_point"][idx]
            hsp = b.series["indoor_dry_bulb_temperature_heating_set_point"][idx]
            if self.cfg.has_occupant:
                ov_c, ov_h = (float(v) for v in self._occ_override[:, bi])
                csp = ov_c if np.isfinite(ov_c) else csp
                hsp = ov_h if np.isfinite(ov_h) else hsp
            h["cooling_sp"][self._t, bi] = csp
            h["heating_sp"][self._t, bi] = hsp
        self._synced_t = self._t

    def _building_series(self, bi: int, condition: str):
        """(net, cost, emission) float64 series of length ``t + 1`` for one
        building under an evaluation condition (reference counterfactual
        properties, ``building.py:308-476,2863-2933``)."""
        self._sync_unwritten_row()
        h = self._history
        n = self._t + 1
        sl = slice(self.episode_tracker.episode_start_time_step,
                   self.episode_tracker.episode_start_time_step + n)
        b = self.spec.buildings[bi]
        net = h["net"][:n, bi].astype(np.float64)
        # without_storage subtracts charger consumption too (building.py:360-366)
        storage = (h["cooling_storage_cons"][:n, bi] + h["heating_storage_cons"][:n, bi]
                   + h["dhw_storage_cons"][:n, bi] + h["battery_cons"][:n, bi]
                   + h["chargers_cons"][:n, bi]).astype(np.float64)
        solar = h["solar"][:n, bi].astype(np.float64)
        if condition == "":
            base = net
        elif condition.startswith("_without_storage"):
            base = net - storage
            if "_and_partial_load" in condition:
                # DynamicsBuilding counterfactual (building.py:2876-2905):
                # add back the ideal-vs-partial load consumption delta.
                t_series = b.series["outdoor_dry_bulb_temperature"][sl].astype(np.float64)
                cool_diff = (b.series["cooling_demand"][sl].astype(np.float64)
                             - h["cooling_demand_actual"][:n, bi].astype(np.float64))
                base = base + _hvac_input_power_np(
                    b.cooling_device, cool_diff, t_series, False)
                heat_diff = (b.series["heating_demand"][sl].astype(np.float64)
                             - h["heating_demand_actual"][:n, bi].astype(np.float64))
                if b.heating_device.is_heat_pump:
                    # quirk: the reference uses the *scalar* outdoor
                    # temperature at the current time step for the whole
                    # heating series (building.py:2893-2897)
                    t_now = float(b.series["outdoor_dry_bulb_temperature"][
                        self.episode_tracker.episode_start_time_step + n - 1])
                    base = base + _hvac_input_power_np(
                        b.heating_device, heat_diff, t_now, True)
                else:
                    base = base + heat_diff / b.dhw_device.efficiency
            if condition.endswith("_and_pv"):
                base = base - solar
        else:
            raise ValueError(condition)
        price = b.series["electricity_pricing"][sl].astype(np.float64)
        carbon = b.series["carbon_intensity"][sl].astype(np.float64)
        if condition == "":
            cost = h["cost"][:n, bi].astype(np.float64)
            emission = h["emission"][:n, bi].astype(np.float64)
        else:
            cost = base * price
            emission = np.clip(base * carbon, 0, None)
        return base, cost, emission

    def evaluate_rows(self, control_condition=None, baseline_condition=None,
                      comfort_band: float = None) -> List[dict]:
        """The rows of :meth:`evaluate`'s frame, in its order, as dicts of
        :data:`KPI_COLUMNS` (numpy only; a building value the reference
        leaves undefined, x/0, is ``None``): first the district level (one
        row per cost function, sorted by name: the mean of the district
        KPI and the building values, skipping undefined ones, as pandas'
        ``groupby(...).mean()`` does), then the building level."""
        self._sync_unwritten_row()
        h = self._history
        n = self._t + 1
        # Default evaluation conditions depend on building type
        # (citylearn.py:1194-1201): dynamics buildings normalize against the
        # no-storage *and ideal-load* baseline.
        has_dynamics = self.spec.buildings[0].dynamics is not None
        control_condition = _condition_value(control_condition) or ""
        baseline_condition = _condition_value(baseline_condition)
        if baseline_condition is None:
            baseline_condition = ("_without_storage_and_partial_load"
                                  if has_dynamics else "_without_storage")

        building_series = self._building_series
        building_rows = []
        for bi, b in enumerate(self.spec.buildings):
            sl = slice(self.episode_tracker.episode_start_time_step,
                       self.episode_tracker.episode_start_time_step + n)
            band = (b.series["comfort_band"][sl] if comfort_band is None
                    else np.full(n, comfort_band))
            dis = kpi.discomfort_np(
                h["indoor_temperature"][:n, bi],
                h["cooling_sp"][:n, bi],
                h["heating_sp"][:n, bi],
                band, b.series["occupant_count"][sl])
            net_c, cost_c, em_c = building_series(bi, control_condition)
            net_b, cost_b, em_b = building_series(bi, baseline_condition)
            carbon_sum = float(b.series["carbon_intensity"][sl].sum())
            price_sum = float(b.series["electricity_pricing"][sl].sum())
            # expected energy uses the *controlled* demand series
            # (citylearn.py:1214: b.cooling_demand is the mutated
            # energy_simulation series, i.e. partial load for dynamics
            # buildings)
            expected = (h["cooling_demand_actual"][:n, bi] + h["heating_demand_actual"][:n, bi]
                        + b.series["dhw_demand"][sl] + b.series["non_shiftable_load"][sl]
                        ).astype(np.float64)
            served = (h["cooling_demand_met"][:n, bi]
                      + np.clip(-h["cooling_storage_balance"][:n, bi], 0, None)
                      + h["heating_demand_met"][:n, bi]
                      + np.clip(-h["heating_storage_balance"][:n, bi], 0, None)
                      + h["dhw_demand_met"][:n, bi]
                      + np.clip(-h["dhw_storage_balance"][:n, bi], 0, None)
                      + h["non_shiftable_load_met"][:n, bi]).astype(np.float64)
            outage = self._outage_np[:n, bi].astype(np.float64)
            vals = {
                "electricity_consumption_total": kpi.safe_div(
                    kpi.electricity_consumption_np(net_c), kpi.electricity_consumption_np(net_b)),
                "zero_net_energy": kpi.safe_div(
                    kpi.zero_net_energy_np(net_c), kpi.zero_net_energy_np(net_b)),
                "carbon_emissions_total": kpi.safe_div(
                    kpi.carbon_emissions_np(em_c),
                    kpi.carbon_emissions_np(em_b) if carbon_sum != 0 else 0),
                "cost_total": kpi.safe_div(
                    kpi.cost_np(cost_c), kpi.cost_np(cost_b) if price_sum != 0 else 0),
                "discomfort_proportion": dis[0],
                "discomfort_cold_proportion": dis[1],
                "discomfort_hot_proportion": dis[2],
                "discomfort_cold_delta_minimum": dis[3],
                "discomfort_cold_delta_maximum": dis[4],
                "discomfort_cold_delta_average": dis[5],
                "discomfort_hot_delta_minimum": dis[6],
                "discomfort_hot_delta_maximum": dis[7],
                "discomfort_hot_delta_average": dis[8],
                "one_minus_thermal_resilience_proportion": kpi.one_minus_thermal_resilience_np(
                    outage, indoor_t=h["indoor_temperature"][:n, bi],
                    cooling_set_point=h["cooling_sp"][:n, bi],
                    heating_set_point=h["heating_sp"][:n, bi],
                    band=band, occupant_count=b.series["occupant_count"][sl]),
                "power_outage_normalized_unserved_energy_total":
                    kpi.normalized_unserved_energy_np(expected, served, outage),
                "annual_normalized_unserved_energy_total":
                    kpi.normalized_unserved_energy_np(expected, served),
            }
            for k, v in vals.items():
                building_rows.append({"cost_function": k, "value": v, "name": b.name,
                                      "level": "building"})

        # district level. Quirk: the district series for the default control
        # condition ('') is the env's *accumulated* per-step list — one entry
        # per update_variables call, so it excludes the final unwritten index
        # (length max(1, steps_taken)) — while counterfactual conditions are
        # summed from building arrays of length t+1 (citylearn.py:645-700,
        # 1888-1918). The control/baseline KPIs therefore see different
        # series lengths; they are reproduced exactly.
        def district_series(condition):
            parts = [building_series(bi, condition)[0] for bi in range(len(self.spec.buildings))]
            total = np.sum(parts, axis=0)
            if condition == "":
                return total[:max(1, self._t)]
            return total

        dc = district_series(control_condition)
        db = district_series(baseline_condition)
        district = {
            "ramping_average": kpi.safe_div(kpi.ramping_np(dc), kpi.ramping_np(db)),
            "daily_one_minus_load_factor_average": kpi.safe_div(
                kpi.one_minus_load_factor_np(dc, 24), kpi.one_minus_load_factor_np(db, 24)),
            "monthly_one_minus_load_factor_average": kpi.safe_div(
                kpi.one_minus_load_factor_np(dc, 730), kpi.one_minus_load_factor_np(db, 730)),
            "daily_peak_average": kpi.safe_div(kpi.peak_np(dc, 24), kpi.peak_np(db, 24)),
            "all_time_peak_average": kpi.safe_div(kpi.peak_np(dc, self.time_steps),
                                                  kpi.peak_np(db, self.time_steps)),
        }
        groups: Dict[str, List[float]] = {k: [v] for k, v in district.items()}
        for r in building_rows:
            groups.setdefault(r["cost_function"], []).append(r["value"])
        district_rows = []
        for k in sorted(groups):
            defined = [float(v) for v in groups[k] if v is not None and not math.isnan(v)]
            mean = math.fsum(defined) / len(defined) if defined else math.nan
            district_rows.append({"cost_function": k, "value": mean, "name": "District",
                                  "level": "district"})
        return district_rows + building_rows

    def evaluate(self, control_condition=None, baseline_condition=None,
                 comfort_band: float = None):
        """The KPI frame of the episode so far (a ``pandas.DataFrame`` of
        :data:`KPI_COLUMNS`; see :meth:`evaluate_rows`)."""
        import pandas as pd
        return pd.DataFrame(self.evaluate_rows(control_condition, baseline_condition,
                                               comfort_band), columns=list(KPI_COLUMNS))

    def render(self):
        if self._renderer is not None:
            self._renderer.render()

    def export_final_kpis(self, model=None, filepath: str = "exported_kpis.csv"):
        if self._renderer is None:
            from citylearn_tpu_torch.envs.render import CSVRenderer
            self._renderer = CSVRenderer(self)
        self._renderer.export_final_kpis(filepath)

    def close(self):
        pass
