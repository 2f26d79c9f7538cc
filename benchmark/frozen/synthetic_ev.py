"""Frozen copy of the port's seeded EV-district writer
(``citylearn_challenge_2022_phase_all_plus_evs``'s shape): battery+PV
buildings with EV chargers and their schedule files, electric vehicles,
washing machines and the EV reward function.

``write_ev_dataset``, ``_charger_schedule``, ``_write_cells`` and the
``CHARGER_OBSERVATIONS``, ``WASHING_MACHINE_OBSERVATIONS`` and
``EV_REWARD_WEIGHTS`` constants copied unchanged from
``citylearn_tpu_torch/synthetic.py`` at commit
cc0635815cd8c53b217ba0e015eed380919f25df; the helpers it shares with the
battery+PV writer come from :mod:`benchmark.frozen.synthetic`, so that the
benchmark's inputs stay the same whatever later changes make to the
program's writers. ``tests/test_torch_ev_district_reference.py`` holds the
copy byte-equal to the program's writer at a small size.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.frozen.synthetic import (
    ACTIONS,
    OBSERVATIONS,
    _battery_and_pv,
    _building_entry,
    _load_and_solar,
    _write_csv,
    _write_schema,
    _write_shared_files,
)

CHARGER_OBSERVATIONS = [
    "electric_vehicle_charger_connected_state",
    "connected_electric_vehicle_at_charger_departure_time",
    "connected_electric_vehicle_at_charger_required_soc_departure",
    "connected_electric_vehicle_at_charger_soc",
    "connected_electric_vehicle_at_charger_battery_capacity",
    "electric_vehicle_charger_incoming_state",
    "incoming_electric_vehicle_at_charger_estimated_arrival_time",
    "incoming_electric_vehicle_at_charger_estimated_soc_arrival",
]
WASHING_MACHINE_OBSERVATIONS = ["washing_machine_start_time_step",
                                "washing_machine_end_time_step"]
EV_REWARD_WEIGHTS = {"no_car_charging": -5.0, "battery_limits": -2.0, "soc_impossible": -10.0,
                     "soc_under": -5.0, "close_soc": 10.0, "self_ev_consumption": 5.0,
                     "extra_self_production": 5.0}


def _write_cells(path: str, columns: dict):
    """Columns of ready-made cells (strings; "" is an empty cell)."""
    names = list(columns)
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in zip(*(columns[k] for k in names)):
            f.write(",".join(row) + "\n")


def _charger_schedule(rng: np.random.RandomState, c: int, n_rows: int, n_docking: int,
                      ev_capacity: list) -> dict:
    """One charger's schedule file. Each day the charger may host one EV,
    ``(c + day) % n_docking``, from an evening hour (16:00-20:00) to a
    morning hour of the next day (05:00-09:00): every stay ends before
    any stay of the next day starts and chargers of one day host
    distinct EVs, so no EV is ever at two chargers in one row. State 1
    marks the connected rows (the last one has 0 hours to departure),
    state 2 the two rows before an announced arrival, state 3 the rest."""
    g = lambda x: "%.6g" % x
    blank = lambda: [""] * n_rows
    state = ["3"] * n_rows
    ev_id, cap, soc, dep, req, eta, est = (blank() for _ in range(7))
    arrive_hour, depart_hour = 16 + c % 5, 5 + (3 * c) % 5
    for day in range(n_rows // 24 + 1):
        skipped, announced = rng.rand() < 0.15, rng.rand() < 0.7
        arrival_soc, required = rng.uniform(20, 60), rng.uniform(70, 95)
        if skipped:
            continue
        v = (c + day) % n_docking
        first, last = day * 24 + arrive_hour, (day + 1) * 24 + depart_hour
        for t in range(first - 2, min(last + 1, n_rows)):
            ev_id[t] = f"EV_{v + 1}"
            if t < first:
                if not announced:
                    ev_id[t] = ""
                    continue
                state[t] = "2"
                eta[t], est[t] = "%d" % (first - t), g(arrival_soc)
            else:
                state[t] = "1"
                frac = (t - first) / (last - first)
                cap[t] = g(ev_capacity[v])
                soc[t] = g(ev_capacity[v] * (arrival_soc + (required - arrival_soc) * frac) / 100)
                dep[t], req[t] = "%d" % (last - t), g(required)
    return {"electric_vehicle_charger_state": state, "electric_vehicle_id": ev_id,
            "electric_vehicle_battery_capacity_khw": cap, "current_soc": soc,
            "electric_vehicle_departure_time": dep,
            "electric_vehicle_required_soc_departure": req,
            "electric_vehicle_estimated_arrival_time": eta,
            "electric_vehicle_estimated_soc_arrival": est}


def write_ev_dataset(root: str, n_buildings: int = 17, n_chargers: int = 8, n_evs: int = 15,
                     n_washing_machines: int = 1, n_rows: int = 8760, seed: int = 0,
                     constraints: bool = False) -> str:
    """Write an EV district under ``root`` and return the path of its
    ``schema.json``. The same arguments always write the same files.

    Buildings are battery+PV buildings as :func:`write_battery_pv_dataset`
    writes them. Chargers 0 and 1 stand on building 0, the others on
    buildings 2, 4, 6, ...; building 1 has none. Charger 0 has
    power-dependent charge and discharge efficiency curves, charger 1
    non-zero minimum powers in both directions, every third charger cannot
    discharge. Up to three EVs never dock (their SOC only drifts); the
    others rotate over the chargers day by day (see
    :func:`_charger_schedule`), some arrivals announced by incoming rows
    and some not, so both ways of forcing the arrival SOC occur. Washing
    machines stand on buildings 1, 3, ...; each day has one start/end
    window, written as row indices. The reward is the
    ``Electric_Vehicles_Reward_Function`` with explicit weights.

    ``constraints=True`` adds charging constraints: building 0 gets a
    building limit and one phase per charger, building 2 a building limit
    alone, all below the chargers' maximum power, so that the limits bind
    under a plan that charges hard."""
    if n_buildings < 3 or n_chargers < 2 or n_evs < n_chargers:
        raise ValueError("an EV district needs 3 buildings, 2 chargers and at least as "
                         "many EVs as chargers")
    charger_building = [0 if c < 2 else min(2 * (c - 1), n_buildings - 1)
                        for c in range(n_chargers)]
    rng = np.random.RandomState(seed)
    cal = _write_shared_files(root, n_rows, rng)
    r2 = lambda lo, hi: float(np.round(rng.uniform(lo, hi), 2))

    buildings = {}
    for b in range(n_buildings):
        name = f"Building_{b + 1}"
        load, solar = _load_and_solar(rng, cal, n_rows)
        energy = {"month": cal["month"], "hour": cal["hour"], "day_type": cal["day_type"],
                  "daylight_savings_status": np.zeros(n_rows, np.int64),
                  "non_shiftable_load": load, "solar_generation": solar}
        _write_csv(os.path.join(root, f"{name}.csv"), energy)
        buildings[name] = _building_entry(name, _battery_and_pv(rng))

    electric_vehicles = {}
    for v in range(n_evs):
        electric_vehicles[f"EV_{v + 1}"] = {"include": True, "battery": {
            "type": "citylearn.energy_model.Battery",
            "attributes": {"capacity": r2(40.0, 80.0), "nominal_power": r2(11.0, 50.0),
                           "initial_soc": r2(0.2, 0.8), "depth_of_discharge": r2(0.7, 0.9),
                           "efficiency": r2(0.9, 0.97), "loss_coefficient": 0.0,
                           "capacity_loss_coefficient": 1e-05}}}
    ev_capacity = [e["battery"]["attributes"]["capacity"] for e in electric_vehicles.values()]
    n_docking = n_evs - min(3, n_evs - n_chargers)

    for c in range(n_chargers):
        cid = f"charger_{charger_building[c] + 1}_{c + 1}"
        _write_cells(os.path.join(root, f"{cid}.csv"),
                     _charger_schedule(rng, c, n_rows, n_docking, ev_capacity))
        attrs = {"efficiency": r2(0.9, 0.98), "max_charging_power": r2(6.0, 11.0),
                 "min_charging_power": 0.0,
                 "max_discharging_power": 0.0 if c % 3 == 2 else r2(5.0, 9.0),
                 "min_discharging_power": 0.0}
        if c == 0:
            attrs["charge_efficiency_curve"] = [[0, 0.83], [0.3, 0.9], [0.7, 0.95], [1, 0.9]]
            attrs["discharge_efficiency_curve"] = [[0, 0.8], [0.5, 0.93], [1, 0.88]]
        if c == 1:
            attrs["min_charging_power"], attrs["min_discharging_power"] = 0.5, 0.4
        buildings[f"Building_{charger_building[c] + 1}"].setdefault("chargers", {})[cid] = {
            "type": "citylearn.electric_vehicle_charger.Charger",
            "charger_simulation": f"{cid}.csv", "attributes": attrs}

    hour = cal["hour"]
    for w in range(n_washing_machines):
        name = f"washing_machine_{w + 1}"
        first = (np.arange(n_rows) // 24) * 24 + 17 + w % 3
        window = (hour >= 12) & (hour <= 22)
        profile = "[%s]" % ", ".join("%.6g" % x for x in np.round(rng.uniform(0.3, 1.5, 3), 2))
        _write_cells(os.path.join(root, f"{name}.csv"), {
            "wm_start_time_step": ["%d" % (s if on else -1) for s, on in zip(first, window)],
            "wm_end_time_step": ["%d" % (s + 3 if on else -1) for s, on in zip(first, window)],
            "load_profile": [f'"{profile}"' if on else "" for on in window]})
        buildings[f"Building_{(2 * w + 1) % n_buildings + 1}"].setdefault(
            "washing_machines", {})[name] = {
                "type": "citylearn.energy_model.WashingMachine",
                "washing_machine_energy_simulation": f"{name}.csv"}

    reward_attributes = {"weights": EV_REWARD_WEIGHTS}
    if constraints:
        on_first = [cid for cid in buildings["Building_1"]["chargers"]]
        buildings["Building_1"]["charging_constraints"] = {
            "building_limit_kw": 6.0,
            "phases": [{"name": f"L{i + 1}", "limit_kw": 4.0 + i, "chargers": [cid]}
                       for i, cid in enumerate(on_first)],
            "observations": {"phase_encoding": True, "headroom": True, "violation": True}}
        buildings["Building_3"]["charging_constraints"] = {"building_limit_kw": 3.0}
        reward_attributes["charging_constraint_penalty_coefficient"] = 2.0

    observations = OBSERVATIONS + CHARGER_OBSERVATIONS + WASHING_MACHINE_OBSERVATIONS
    actions = ACTIONS + ["electric_vehicle_storage", "washing_machine"]
    return _write_schema(
        root, n_rows, seed, observations,
        {"electrical_storage", "electric_vehicle_storage", "washing_machine"}, buildings,
        action_names=actions,
        reward_function={
            "type": "citylearn.reward_function.Electric_Vehicles_Reward_Function",
            "attributes": reward_attributes},
        extra={"electric_vehicles_def": electric_vehicles})
