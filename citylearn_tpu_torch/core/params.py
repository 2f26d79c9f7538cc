"""Pack a compiled :class:`DistrictSpec` into tensors + static config.

Data layout is time-major ``(T, B)`` so each step gathers one contiguous
``(B,)`` row per field (replaces the reference's per-step
``TimeSeriesData.__getattr__`` slicing, ``data.py:313``). The packed
leaves equal those of the JAX package's ``pack`` for the battery+PV,
thermal-storage, EV and LSTM-dynamics districts, at float32 and, for the
float64 parity mode, at float64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, get_type_hints

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.compiler.events import resolve_ev_events
from citylearn_tpu_torch.compiler.spaces import heat_pump_cop_np
from citylearn_tpu_torch.compiler.spec import BuildingSpec, DistrictSpec
from citylearn_tpu_torch.envs.outage import building_outage_signal
from citylearn_tpu_torch.core.types import (
    BatteryParams,
    ChargerParams,
    DistrictParams,
    DynamicsParams,
    EnvState,
    EVParams,
    HVACParams,
    OccupantParams,
    SeriesData,
    StaticConfig,
    StorageTankParams,
    WashingMachineParams,
    map_tensors,
)

PERIODIC_MAX = {"hour": 24, "day_type": 7, "month": 12, "minutes": 60}
DYNAMIC_CHANNELS = ("indoor_dry_bulb_temperature", "cooling_demand", "heating_demand")

# Observation names whose returned-at-t value is state-derived and therefore
# *zero* at any index the step has not written yet (the reference returns
# observations at t+1 before anything is written there)
DERIVED_ZERO_OBSERVATIONS = frozenset({
    "cooling_storage_soc", "heating_storage_soc", "dhw_storage_soc",
    "electrical_storage_soc", "net_electricity_consumption",
    "cooling_electricity_consumption", "heating_electricity_consumption",
    "dhw_electricity_consumption", "cooling_storage_electricity_consumption",
    "heating_storage_electricity_consumption",
    "dhw_storage_electricity_consumption",
    "electrical_storage_electricity_consumption",
    "washing_machine_electricity_consumption",
})


@dataclasses.dataclass(frozen=True)
class ObsLayout:
    """Static observation metadata: the union column order and each
    building's active subset (as indices into the union)."""
    union_names: Tuple[str, ...]
    building_indices: Tuple[Tuple[int, ...], ...]   # per building

    def column(self, name: str) -> int:
        return self.union_names.index(name)


def build_obs_layout(spec: DistrictSpec) -> ObsLayout:
    union: List[str] = []
    for b in spec.buildings:
        for k in b.active_observations:
            if k not in union:
                union.append(k)
    indices = tuple(tuple(union.index(k) for k in b.active_observations)
                    for b in spec.buildings)
    return ObsLayout(union_names=tuple(union), building_indices=indices)


def _stack(spec: DistrictSpec, key: str, dtype=np.float32) -> np.ndarray:
    """(T, B) stack of one series over the simulation range."""
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)
    cols = [b.series[key][sl] for b in spec.buildings]
    return np.stack(cols, axis=1).astype(dtype)


def _obs_series(b: BuildingSpec, name: str, sl: slice) -> np.ndarray:
    """Data-driven value of observation ``name`` for one building over the
    simulation range (reference ``building.py:1336-1481`` data paths)."""
    s = b.series
    n = len(s["hour"][sl])
    if name in DERIVED_ZERO_OBSERVATIONS:
        return np.zeros(n, np.float32)
    if name == "power_outage":
        # zeros unless the CSV signal is simulated (building.py:1458); a
        # stochastic signal is resolved per episode and is not data
        if b.simulate_power_outage and not b.stochastic_power_outage:
            return s["power_outage"][sl]
        return np.zeros(n, np.float32)
    if name == "solar_generation":
        return np.abs(b.pv_nominal_power * s["solar_generation"][sl] / 1000.0)
    if name == "cooling_device_efficiency":
        return heat_pump_cop_np(s["outdoor_dry_bulb_temperature"][sl],
                                b.cooling_device.efficiency,
                                b.cooling_device.target_cooling_temperature, False)
    if name in ("heating_device_efficiency", "dhw_device_efficiency"):
        device = b.heating_device if name == "heating_device_efficiency" else b.dhw_device
        if device.is_heat_pump:
            return heat_pump_cop_np(s["outdoor_dry_bulb_temperature"][sl],
                                    device.efficiency,
                                    device.target_heating_temperature, True)
        return np.full(n, device.efficiency, np.float32)
    if name == "indoor_dry_bulb_temperature_cooling_delta":
        return (s["indoor_dry_bulb_temperature"][sl]
                - s["indoor_dry_bulb_temperature_cooling_set_point"][sl])
    if name == "indoor_dry_bulb_temperature_heating_delta":
        return (s["indoor_dry_bulb_temperature"][sl]
                - s["indoor_dry_bulb_temperature_heating_set_point"][sl])
    if name in s:
        return s[name][sl]
    return np.zeros(n, np.float32)


def _ev_obs_columns(spec: DistrictSpec, T: int) -> Dict[Tuple[int, str], np.ndarray]:
    """Data-driven values for per-charger / per-WM observation columns
    (reference ``building.py:1221-1331``), keyed by (building, name). The
    SOC column holds the value visible at *observation* time: the forced
    arrival SOC when an EV just (re)connected, else the reference's stale
    0.0."""
    cols = {}
    n_evs = len(spec.electric_vehicles)
    force = None
    if any(b.chargers for b in spec.buildings) and n_evs:
        force, _ = resolve_ev_events(spec.buildings, n_evs, T, drift_seed=spec.random_seed)
    for bi, b in enumerate(spec.buildings):
        for ch in b.chargers:
            cid = ch.charger_id
            conn = ch.connected_ev >= 0
            inc = ch.incoming_ev >= 0
            n = len(conn)
            soc_col = np.full(n, -0.1, np.float32)
            if force is not None:
                f = force[np.arange(min(n, len(force))),
                          np.clip(ch.connected_ev[:len(force)], 0, None)]
                soc_vis = np.where(np.isfinite(f), f, 0.0)
                soc_col[:len(f)] = np.where(conn[:len(f)], soc_vis, -0.1)
            f32 = lambda a: a.astype(np.float32)
            at = f"connected_electric_vehicle_at_charger_{cid}"
            incoming = f"incoming_electric_vehicle_at_charger_{cid}"
            cols[(bi, f"electric_vehicle_charger_{cid}_connected_state")] = f32(conn)
            cols[(bi, f"{at}_departure_time")] = f32(np.where(conn, ch.departure_time, -1))
            cols[(bi, f"{at}_required_soc_departure")] = f32(np.where(conn, ch.required_soc, -0.1))
            cols[(bi, f"{at}_soc")] = soc_col
            cols[(bi, f"{at}_battery_capacity")] = f32(np.where(conn, ch.capacity_kwh, -1.0))
            cols[(bi, f"electric_vehicle_charger_{cid}_incoming_state")] = f32(inc)
            cols[(bi, f"{incoming}_estimated_arrival_time")] = f32(
                np.where(inc, ch.arrival_time, -1))
            cols[(bi, f"{incoming}_estimated_soc_arrival")] = f32(
                np.where(inc, ch.estimated_soc_arrival, -0.1))
        for wm in b.washing_machines:
            cols[(bi, f"{wm.name}_start_time_step")] = wm.wm_start.astype(np.float32)
            cols[(bi, f"{wm.name}_end_time_step")] = wm.wm_end.astype(np.float32)
        # charging-constraint phase one-hots are static data; headroom and
        # violation columns stay zero (the Gym env overrides them at run time)
        cc = b.charging_constraints
        if cc and (cc.get("observations") or {}).get("phase_encoding"):
            phase_map = {cid: (p.get("name") or "")
                         for p in (cc.get("phases") or [])
                         for cid in (p.get("chargers") or [])}
            for name in b.active_observations:
                if name.startswith("charging_phase_one_hot_"):
                    rest = name[len("charging_phase_one_hot_"):]
                    for ch in b.chargers:
                        if rest.startswith(ch.charger_id + "_"):
                            pn = rest[len(ch.charger_id) + 1:]
                            assigned = phase_map.get(ch.charger_id, "unassigned")
                            cols[(bi, name)] = np.full(
                                T, 1.0 if assigned == pn else 0.0, np.float32)
    return cols


def _obs_static(spec: DistrictSpec, layout: ObsLayout) -> np.ndarray:
    """(T, B, K_union) data-driven observation matrix."""
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)
    T = spec.simulation_time_steps
    obs = np.zeros((T, spec.n_buildings, len(layout.union_names)), np.float32)
    ev_cols = _ev_obs_columns(spec, T)
    for bi, b in enumerate(spec.buildings):
        for ki, name in enumerate(layout.union_names):
            if name not in b.active_observations:
                continue
            if (bi, name) in ev_cols:
                col = ev_cols[(bi, name)]
                obs[:len(col), bi, ki] = col[:T]
            else:
                obs[:, bi, ki] = _obs_series(b, name, sl)
    return obs


def _pack_evs(spec: DistrictSpec, episode_steps: int, t, param_dtype=np.float32
              ) -> Tuple[Optional[ChargerParams], Optional[EVParams],
                         Optional[WashingMachineParams], Dict]:
    """Stack chargers/EVs/washing machines + precompile SOC event tensors;
    ``t`` puts a numpy array on the device and ``param_dtype`` is the
    dtype of the device parameters (the schema's Python floats). Also
    returns the ``StaticConfig`` fields of the EV family."""
    all_chargers = [ch for b in spec.buildings for ch in b.chargers]
    all_wms = [wm for b in spec.buildings for wm in b.washing_machines]
    n_evs = len(spec.electric_vehicles)
    cfg = dict(has_evs=len(all_chargers) > 0,
               has_washing_machines=len(all_wms) > 0,
               n_chargers=len(all_chargers), n_evs=n_evs,
               n_washing_machines=len(all_wms))
    rb_attrs = (spec.schema.get("reward_function") or {}).get("attributes") or {}
    weights = rb_attrs.get("weights")
    if weights:
        cfg["ev_reward_weights"] = (
            float(weights.get("no_car_charging", -5.0)),
            float(weights.get("battery_limits", -2.0)),
            float(weights.get("soc_impossible", -10.0)),
            float(weights.get("soc_under", -5.0)),
            float(weights.get("close_soc", 10.0)),
            float(weights.get("self_ev_consumption", 5.0)),
            float(weights.get("extra_self_production", 5.0)))

    chargers = evs = wms = None
    f32 = lambda vals: t(np.asarray(vals, np.float32))
    pf = lambda vals: t(np.asarray(vals, param_dtype))
    i32 = lambda vals: t(np.asarray(vals, np.int32))
    if all_chargers:
        def sched(field):
            # pad/trim schedule arrays to the episode length (indexed by
            # episode-relative t, like the reference's un-windowed data)
            cols = []
            for ch in all_chargers:
                a = np.asarray(getattr(ch, field), np.float32)
                if len(a) < episode_steps:
                    a = np.pad(a, (0, episode_steps - len(a)), constant_values=-1)
                cols.append(a[:episode_steps])
            return np.stack(cols, axis=1)

        # charging-constraint tables (building.py:764-994)
        cc_building = np.full(spec.n_buildings, np.inf, np.float32)
        cc_phase_index = np.full(len(all_chargers), -1, np.int32)
        cc_phase_limits, cc_phase_buildings = [], []
        has_cc = False
        cid_to_slot = {ch.charger_id: i for i, ch in enumerate(all_chargers)}
        for b in spec.buildings:
            cc = b.charging_constraints
            if not cc:
                continue
            has_cc = True
            if cc.get("building_limit_kw") is not None:
                cc_building[b.index] = float(cc["building_limit_kw"])
            for phase in (cc.get("phases") or []):
                limit = phase.get("limit_kw")
                pid = len(cc_phase_limits)
                cc_phase_limits.append(np.inf if limit is None else float(limit))
                cc_phase_buildings.append(b.index)
                for cid in (phase.get("chargers") or []):
                    if cid in cid_to_slot:
                        cc_phase_index[cid_to_slot[cid]] = pid
        if not cc_phase_limits:
            cc_phase_limits, cc_phase_buildings = [np.inf], [0]
        cfg["has_charging_constraints"] = has_cc
        cfg["n_charging_phases"] = len(cc_phase_limits)
        cfg["charging_penalty_coefficient"] = float(
            rb_attrs.get("charging_constraint_penalty_coefficient") or 1.0)

        per_charger = lambda name: pf([getattr(ch, name) for ch in all_chargers])
        chargers = ChargerParams(
            **{name: per_charger(name) for name in (
                "efficiency", "charge_eff_x", "charge_eff_y", "discharge_eff_x",
                "discharge_eff_y", "max_charging_power", "min_charging_power",
                "max_discharging_power", "min_discharging_power")},
            building_index=i32([ch.building_index for ch in all_chargers]),
            connected_ev=t(sched("connected_ev").astype(np.int32)),
            departure_time=t(sched("departure_time")),
            required_soc=t(sched("required_soc")),
            capacity_kwh=t(sched("capacity_kwh")),
            cc_phase_index=t(cc_phase_index),
            cc_building_limit=t(cc_building),
            cc_phase_limit=f32(cc_phase_limits),
            cc_phase_building=i32(cc_phase_buildings))
        force, drift = resolve_ev_events(spec.buildings, n_evs, episode_steps,
                                         drift_seed=spec.random_seed)
        per_ev = lambda name: np.asarray([getattr(e.battery, name)
                                          for e in spec.electric_vehicles])
        evs = EVParams(
            battery=BatteryParams(**{
                f.name: t(v if v.dtype == bool else v.astype(param_dtype))
                for f in dataclasses.fields(BatteryParams) for v in [per_ev(f.name)]}),
            force_soc=t(force), drift_mult=t(drift))
    if all_wms:
        starts, ends, loads = [], [], []
        for wm in all_wms:
            tl = np.zeros(episode_steps, np.float32)
            for step in range(min(episode_steps, len(wm.load_profiles))):
                # reference energy_model.py:1327-1330: only entries whose
                # (unused) target step fits the episode are added — and all
                # of them land on the trigger step
                profile = np.atleast_1d(wm.load_profiles[step])
                n_fit = max(0, min(len(profile), episode_steps - step))
                tl[step] = float(np.sum(profile[:n_fit]))
            starts.append(np.asarray(wm.wm_start, np.int32)[:episode_steps])
            ends.append(np.asarray(wm.wm_end, np.int32)[:episode_steps])
            loads.append(tl)
        wms = WashingMachineParams(
            building_index=i32([wm.building_index for wm in all_wms]),
            wm_start=t(np.stack(starts, axis=1)),
            wm_end=t(np.stack(ends, axis=1)),
            triggered_load=t(np.stack(loads, axis=1)))
    return chargers, evs, wms, cfg


def _pack_dynamics(spec: DistrictSpec, sl: slice, t) -> Tuple[Tuple[DynamicsParams, ...], Dict]:
    """Group buildings by identical LSTM shape/channels and stack each
    group's weights + precomputed static input channels; ``t`` puts a
    numpy array on the device. Also returns the ``StaticConfig`` fields
    of the dynamics family (empty without dynamics)."""
    members_of: Dict[tuple, List[int]] = {}
    for bi, b in enumerate(spec.buildings):
        if b.dynamics is not None:
            d = b.dynamics
            key = (tuple(d.input_observation_names), d.hidden_size, d.num_layers, d.lookback)
            members_of.setdefault(key, []).append(bi)      # keeps building order
    if not members_of:
        return (), {}
    if sum(len(m) for m in members_of.values()) != len(spec.buildings):
        raise NotImplementedError("mixed dynamics/plain building districts not yet supported")
    T = sl.stop - sl.start

    def channel_series(b: BuildingSpec, name: str) -> np.ndarray:
        for k, xmax in PERIODIC_MAX.items():
            if name in (f"{k}_sin", f"{k}_cos"):
                fn = np.sin if name.endswith("_sin") else np.cos
                return fn(2 * np.pi * b.series[k][sl] / xmax).astype(np.float32)
        if name in b.series:
            return b.series[name][sl].astype(np.float32)
        raise NotImplementedError(f"dynamics input channel {name}")

    f32 = lambda arrs: t(np.stack(arrs).astype(np.float32))
    packed, metas = [], []
    for (names, H, L, lookback), members in members_of.items():
        ds = [spec.buildings[bi].dynamics for bi in members]
        static = np.zeros((T, len(members), len(names)), np.float32)
        for gi, (bi, d) in enumerate(zip(members, ds)):
            for fi, name in enumerate(names):
                if name not in DYNAMIC_CHANNELS:
                    lo, hi = d.norm_min[fi], d.norm_max[fi]
                    static[:, gi, fi] = (channel_series(spec.buildings[bi], name) - lo) / (hi - lo)
        active = lambda action: t(np.asarray(
            [action in spec.buildings[bi].active_actions for bi in members]))
        packed.append(DynamicsParams(
            member_indices=t(np.asarray(members, np.int32)),
            w_ih=tuple(f32([d.w_ih[l] for d in ds]) for l in range(L)),
            w_hh=tuple(f32([d.w_hh[l] for d in ds]) for l in range(L)),
            bias=tuple(f32([d.bias[l] for d in ds]) for l in range(L)),
            lin_w=f32([d.lin_w for d in ds]),
            lin_b=t(np.asarray([d.lin_b for d in ds], np.float32)),
            norm_min=f32([d.norm_min for d in ds]),
            norm_max=f32([d.norm_max for d in ds]),
            static_channels=t(static),
            cooling_device_active=active("cooling_device"),
            heating_device_active=active("heating_device"),
            cooling_or_heating_active=active("cooling_or_heating_device")))
        channel = lambda name: names.index(name) if name in names else -1
        metas.append((lookback, L, H, len(names), names.index("indoor_dry_bulb_temperature"),
                      channel("cooling_demand"), channel("heating_demand")))
    return tuple(packed), dict(has_dynamics=True, dyn_groups=tuple(metas),
                               max_lookback=max(m[0] for m in metas))


def _pack_occupant(spec: DistrictSpec, episode_steps: int, t) -> Tuple[Optional[OccupantParams], Dict]:
    """Stack the occupant interaction models over buildings and draw the
    per-step seeded uniforms (``occupant.py:69-71``: a fresh
    ``RandomState(max(seed, 1) + t)`` per step, the same for every
    building because every occupant shares the env seed); ``t`` puts a
    numpy array on the device. Also returns the ``StaticConfig`` fields of
    the occupant family (empty without occupants)."""
    occs = [b.occupant for b in spec.buildings]
    if all(o is None for o in occs):
        return None, {}
    if any(o is None for o in occs):
        raise NotImplementedError("mixed occupant/plain dynamics districts not yet supported")
    n_nodes = max(o.tree_children_left.shape[1] for o in occs)
    depth = max(o.max_depth for o in occs)

    def nodes(field, fill):
        arrs = [getattr(o, field) for o in occs]
        out = np.full((len(occs), 2, n_nodes), fill, arrs[0].dtype)
        for i, arr in enumerate(arrs):
            out[i, :, :arr.shape[1]] = arr
        return t(out)

    seed = max(spec.random_seed, 1)
    rand = np.asarray([np.random.RandomState(seed + step).uniform()
                       for step in range(episode_steps)], np.float32)
    series = lambda field: t(np.stack([getattr(o, field)[:episode_steps] for o in occs],
                                      axis=1).astype(np.float32))
    occ = OccupantParams(
        a_increase=series("a_increase"),
        b_increase=series("b_increase"),
        a_decrease=series("a_decrease"),
        b_decrease=series("b_decrease"),
        random_probability=t(rand),
        tree_children_left=nodes("tree_children_left", -1),
        tree_children_right=nodes("tree_children_right", -1),
        tree_feature=nodes("tree_feature", -2),
        tree_threshold=nodes("tree_threshold", 0.0),
        tree_delta=nodes("tree_delta", 0.0),
        hold_time_steps=t(np.asarray([min(o.set_point_hold_time_steps, 2 ** 30) for o in occs],
                                     np.int32)),
        lookback=t(np.asarray([b.dynamics.lookback if b.dynamics else 0
                               for b in spec.buildings], np.int32)))
    return occ, dict(has_occupant=True, occupant_tree_depth=depth)


def rebake_outage(spec: DistrictSpec, cfg: StaticConfig, params: DistrictParams,
                  data_offset: int) -> DistrictParams:
    """Re-bake stochastic-outage signals for the episode window starting
    at sim-range row ``data_offset`` (:func:`pack` bakes rows
    [0, episode_steps) only). Returns params with the signal written at
    rows [data_offset, data_offset + episode_steps); CSV-driven outage
    columns are untouched (they are sim-range data already)."""
    off = int(data_offset)
    if not cfg.has_stochastic_outage or off == 0:
        return params
    ep_steps = _episode_steps(spec)
    full = params.series.power_outage.cpu().numpy().copy()
    for bi, b in enumerate(spec.buildings):
        if not (b.simulate_power_outage and b.stochastic_power_outage):
            continue
        start = spec.simulation_start_time_step + off
        sig = building_outage_signal(b, ep_steps, spec.seconds_per_time_step,
                                     slice(start, start + ep_steps))
        full[:, bi] = 0.0
        n = min(ep_steps, full.shape[0] - off)
        full[off:off + n, bi] = sig[:n]
    return dataclasses.replace(params, series=dataclasses.replace(
        params.series, power_outage=torch.as_tensor(full, device=params.device)))


def _episode_steps(spec: DistrictSpec) -> int:
    steps = spec.episode_time_steps
    if steps is None:
        return spec.simulation_time_steps
    if isinstance(steps, list):
        return int(steps[0][1] - steps[0][0] + 1)
    return int(steps)


def _reward_config(spec: DistrictSpec) -> Dict:
    """StaticConfig reward fields from the schema's ``reward_function``."""
    reward_block = spec.schema.get("reward_function") or {}
    raw_type = reward_block.get("type")
    raw_attrs = reward_block.get("attributes") or {}
    reward_per_building = None
    if isinstance(raw_type, dict):
        # MultiBuildingRewardFunction (reference citylearn.py:2108-2141):
        # per-building dotted paths with 'default' fallback (else the first
        # entry); attributes dict follows the same fallback
        default_type = raw_type.get("default")
        if default_type is None and raw_type:
            default_type = next(iter(raw_type.values()))
        default_attrs = raw_attrs.get("default")
        if default_attrs is None and raw_attrs:
            default_attrs = next(iter(raw_attrs.values()))
        per = []
        for b in spec.buildings:
            t = raw_type.get(b.name, default_type)
            if t is None:
                raise ValueError(f"no reward function for building {b.name!r} "
                                 "and no default provided")
            a = raw_attrs.get(b.name, default_attrs) or {}
            per.append((t.rsplit(".", 1)[-1],
                        float(a.get("exponent") or 1.0),
                        None if a.get("band") is None else float(a["band"]),
                        float(a.get("lower_exponent") or 2.0),
                        float(a.get("higher_exponent") or 2.0),
                        tuple(a.get("coefficients") or (1.0, 1.0))))
        reward_per_building = tuple(per)
        reward_type = "MultiBuildingRewardFunction"
        reward_attrs = {}
    else:
        reward_type = (raw_type or
                       "citylearn.reward_function.RewardFunction").rsplit(".", 1)[-1]
        reward_attrs = raw_attrs
    return dict(
        reward_type=reward_type,
        reward_exponent=float(reward_attrs.get("exponent") or 1.0),
        reward_band=(None if reward_attrs.get("band") is None
                     else float(reward_attrs["band"])),
        reward_lower_exponent=float(reward_attrs.get("lower_exponent") or 2.0),
        reward_higher_exponent=float(reward_attrs.get("higher_exponent") or 2.0),
        reward_coefficients=tuple(reward_attrs.get("coefficients") or (1.0, 1.0)),
        reward_per_building=reward_per_building,
    )


def pack(spec: DistrictSpec, device=None, param_dtype: torch.dtype = torch.float32
         ) -> Tuple[StaticConfig, DistrictParams, ObsLayout]:
    """``(cfg, params, layout)`` of a compiled district, with every
    parameter tensor on ``device`` (the CUDA card by default).

    ``param_dtype=torch.float64`` packs for the float64 parity mode: the
    device parameters (Python floats in the reference, schema JSON values)
    at float64, then every float32 leaf but the LSTM groups lifted to
    float64 (losslessly: the reference's data arrays are float32), and
    ``cfg.parity_f64`` set."""
    dev = resolve_device(device)
    parity = param_dtype == torch.float64
    if not parity and param_dtype != torch.float32:
        raise ValueError(f"param_dtype must be torch.float32 or torch.float64, not {param_dtype}")
    np_dtype = np.float64 if parity else np.float32
    sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)

    solar = np.stack(
        [b.pv_nominal_power * b.series["solar_generation"][sl] / 1000.0
         for b in spec.buildings], axis=1).astype(np.float32)
    # Outage signals: data-driven from the CSV; a stochastic model resolves
    # deterministically per reset in the reference (a fresh
    # RandomState(seed) each time, building.py:2566-2594), so the signal of
    # the default window is baked here (see rebake_outage for the others)
    ep_steps = _episode_steps(spec)
    outage_cols = []
    for b in spec.buildings:
        if b.simulate_power_outage and b.stochastic_power_outage:
            start = spec.simulation_start_time_step
            col = np.zeros(spec.simulation_time_steps, np.float32)
            col[:ep_steps] = building_outage_signal(
                b, ep_steps, spec.seconds_per_time_step, slice(start, start + ep_steps))
            outage_cols.append(col)
        elif b.simulate_power_outage:
            outage_cols.append(b.series["power_outage"][sl])
        else:
            outage_cols.append(np.zeros_like(b.series["power_outage"][sl]))
    outage = np.stack(outage_cols, axis=1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)

    series = SeriesData(
        non_shiftable_load=t(_stack(spec, "non_shiftable_load")),
        cooling_demand=t(_stack(spec, "cooling_demand")),
        heating_demand=t(_stack(spec, "heating_demand")),
        dhw_demand=t(_stack(spec, "dhw_demand")),
        solar_generation=t(solar),
        outdoor_dry_bulb_temperature=t(_stack(spec, "outdoor_dry_bulb_temperature")),
        electricity_pricing=t(_stack(spec, "electricity_pricing")),
        carbon_intensity=t(_stack(spec, "carbon_intensity")),
        power_outage=t(outage),
        hvac_mode=t(_stack(spec, "hvac_mode", np.int32)),
        hour=t(_stack(spec, "hour", np.int32)),
        indoor_dry_bulb_temperature=t(_stack(spec, "indoor_dry_bulb_temperature")),
        indoor_dry_bulb_temperature_cooling_set_point=t(
            _stack(spec, "indoor_dry_bulb_temperature_cooling_set_point")),
        indoor_dry_bulb_temperature_heating_set_point=t(
            _stack(spec, "indoor_dry_bulb_temperature_heating_set_point")),
        comfort_band=t(_stack(spec, "comfort_band")),
        occupant_count=t(_stack(spec, "occupant_count")),
    )

    def block(cls, attr):
        """Stack one device's resolved attributes over the buildings."""
        vals = {f.name: np.asarray([getattr(getattr(b, attr), f.name) for b in spec.buildings])
                for f in dataclasses.fields(cls)}
        return cls(**{k: t(v if v.dtype == bool else v.astype(np_dtype))
                      for k, v in vals.items()})

    chargers, evs, wms, ev_cfg = _pack_evs(spec, ep_steps, t, np_dtype)
    dynamics, dyn_cfg = _pack_dynamics(spec, sl, t)
    occupant, occ_cfg = _pack_occupant(spec, ep_steps, t)
    # a dynamics district always steps the cooling and heating blocks
    has_dynamics = bool(dyn_cfg)
    cfg = StaticConfig(
        n_buildings=spec.n_buildings,
        time_steps=ep_steps,
        central_agent=spec.central_agent,
        seconds_per_time_step=spec.seconds_per_time_step,
        time_step_ratio=spec.time_step_ratio,
        parity_f64=parity,
        simulate_power_outage=tuple(b.simulate_power_outage for b in spec.buildings),
        has_stochastic_outage=any(b.simulate_power_outage and b.stochastic_power_outage
                                  for b in spec.buildings),
        any_cooling=has_dynamics or any(
            float(b.series["cooling_demand"][sl].max()) > 0
            or b.cooling_storage.capacity > 0 for b in spec.buildings),
        any_heating=has_dynamics or any(
            float(b.series["heating_demand"][sl].max()) > 0
            or b.heating_storage.capacity > 0 for b in spec.buildings),
        any_dhw=any(float(b.series["dhw_demand"][sl].max()) > 0
                    or b.dhw_storage.capacity > 0 for b in spec.buildings),
        **_reward_config(spec),
        **dyn_cfg,
        **occ_cfg,
        **ev_cfg,
    )
    layout = build_obs_layout(spec)
    params = DistrictParams(
        series=series, battery=block(BatteryParams, "battery"),
        **{name: block(HVACParams, name)
           for name in ("cooling_device", "heating_device", "dhw_device")},
        **{name: block(StorageTankParams, name)
           for name in ("cooling_storage", "heating_storage", "dhw_storage")},
        obs_static=t(_obs_static(spec, layout)),
        dynamics=dynamics, occupant=occupant, chargers=chargers, evs=evs,
        washing_machines=wms)
    if parity:
        # the LSTM groups stay float32, like the reference's torch models
        params = dataclasses.replace(lift_f64(dataclasses.replace(params, dynamics=())),
                                     dynamics=dynamics)
    return cfg, params, layout


def lift_f64(tree):
    """A copy of ``tree`` with every float32 tensor lifted to float64."""
    return map_tensors(lambda x: x.double() if x.dtype == torch.float32 else x, tree)


def params_from_numpy(tree: Dict[str, np.ndarray], device=None) -> DistrictParams:
    """:class:`DistrictParams` from a flat ``{"series.hour": array, ...}``
    dict keyed by field path — the JAX package's packed parameters
    carried across as numpy arrays. Keys the port does not read are
    ignored; a missing key raises
    ``KeyError``, except that a charger, EV or washing-machine block with
    no key at all is absent (``None``), as on a district without them;
    the dynamics groups and their per-layer weights are keyed by index
    (``"dynamics.0.w_ih.1"``)."""
    dev = resolve_device(device)

    def build(cls, prefix=""):
        out = {}
        for name, kind in get_type_hints(cls).items():
            path = f"{prefix}{name}"
            args = getattr(kind, "__args__", ())
            nested = [a for a in args if dataclasses.is_dataclass(a)]
            if getattr(kind, "__origin__", None) is tuple:
                # a tuple of blocks or of tensors, keyed by index
                member = (lambda p: build(nested[0], p + ".")) if nested else leaf
                n = len({k[len(path) + 1:].split(".")[0] for k in tree
                         if k.startswith(path + ".")})
                out[name] = tuple(member(f"{path}.{i}") for i in range(n))
            elif nested:
                present = any(k.startswith(path + ".") for k in tree)
                out[name] = build(nested[0], path + ".") if present else None
            elif dataclasses.is_dataclass(kind):
                out[name] = build(kind, path + ".")
            else:
                out[name] = leaf(path)
        return cls(**out)

    leaf = lambda path: torch.tensor(np.asarray(tree[path]), device=dev)
    return build(DistrictParams)


def initial_state(cfg: StaticConfig, params: DistrictParams,
                  data_offset: int = 0) -> EnvState:
    """Episode-start state of one district (reference ``Building.reset``
    semantics: SOC index 0 = initial_soc, efficiency history truncated to
    its base, capacity history truncated to nominal capacity —
    ``building.py:2526-2564``, ``energy_model.py:797-803,1237-1242``)."""
    dev = params.device
    if cfg.has_evs:
        ev_soc, ev_eff, ev_deg = (params.evs.battery.initial_soc.clone(),
                                  params.evs.battery.efficiency.clone(),
                                  params.evs.battery.capacity.clone())
    else:
        ev_soc, ev_eff, ev_deg = (torch.zeros(0, dtype=torch.float32, device=dev)
                                  for _ in range(3))
    lstm_h, dyn_input = [], []
    for (lookback, L, H, F, *_), dyn in zip(cfg.dyn_groups, params.dynamics):
        Bg = dyn.member_indices.shape[0]
        lstm_h.append(torch.zeros((L, Bg, H), dtype=torch.float32, device=dev))
        dyn_input.append(torch.zeros((Bg, F, lookback + 1), dtype=torch.float32, device=dev))
    n_occ = cfg.n_buildings if cfg.has_occupant else 0
    full = lambda value, dtype=torch.float32: torch.full((n_occ,), value, dtype=dtype, device=dev)
    return EnvState(
        occ_csp_override=full(float("nan")), occ_hsp_override=full(float("nan")),
        occ_hold_counter=full(-1, torch.int32),
        occ_prev_temp=full(0.0), occ_prev_csp=full(0.0), occ_prev_hsp=full(0.0),
        lstm_h=tuple(lstm_h), lstm_c=tuple(torch.zeros_like(h) for h in lstm_h),
        dyn_input=tuple(dyn_input),
        ev_soc=ev_soc, ev_efficiency=ev_eff, ev_degraded_capacity=ev_deg,
        wm_initiated=torch.zeros(cfg.n_washing_machines, dtype=torch.bool, device=dev),
        t=torch.tensor(0, dtype=torch.int32, device=dev),
        data_offset=torch.tensor(data_offset, dtype=torch.int32, device=dev),
        battery_soc=params.battery.initial_soc.clone(),
        battery_efficiency=params.battery.efficiency.clone(),
        battery_degraded_capacity=params.battery.capacity.clone(),
        cooling_storage_soc=params.cooling_storage.initial_soc.clone(),
        heating_storage_soc=params.heating_storage.initial_soc.clone(),
        dhw_storage_soc=params.dhw_storage.initial_soc.clone(),
    )
