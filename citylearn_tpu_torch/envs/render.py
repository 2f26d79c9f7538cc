"""CSV render/export channel (reference ``citylearn.py:1502-1652``).

Streams per-entity CSVs (community, building, battery, charger, pricing,
EV) with ISO timestamps derived from ``start_date``, in ``'during'``
(per-step append) or ``'end'`` (buffered flush) modes, plus the final KPI
pivot CSV. Column sets mirror the reference's ``as_dict`` payloads exactly
(``citylearn.py:2651``, ``building.py:2711``, ``energy_model.py:1228``,
``electric_vehicle_charger.py:354``, ``data.py:629``,
``electric_vehicle.py:112``) so the CityLearn UI can consume them,
including the charger file's state-dependent EV column block and the
reference's grow-the-header CSV rewrite semantics.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from datetime import datetime, timedelta
from typing import Mapping, Optional

import numpy as np


class CSVRenderer:
    def __init__(self, env, directory: str = "render_exports",
                 session_name: Optional[str] = None, mode: str = "during",
                 start_date: Optional[str] = None):
        assert mode in ("during", "end")
        self.env = env
        self.mode = mode
        self.start_date = datetime.fromisoformat(start_date) if start_date \
            else datetime(2017, 1, 1)
        session = session_name or datetime.now().strftime("session_%Y%m%d_%H%M%S")
        self.directory = os.path.join(directory, session)
        self._buffer = defaultdict(list)

    def _timestamp(self, t: int) -> str:
        seconds = t * self.env.spec.seconds_per_time_step
        return (self.start_date + timedelta(seconds=seconds)).isoformat()

    # ------------------------------------------------------------------
    def render(self):
        """One row per entity for the just-written step (the reference
        renders at the top of ``next_time_step``, i.e. at the index the
        step's ``update_variables`` wrote; ``citylearn.py:1325``)."""
        env = self.env
        # called after the adapter increments time_step; the freshly
        # written history row is time_step - 1
        t = max(0, min(env.time_step - 1, env.time_steps - 1))
        ep = env.episode_tracker.episode
        ts = self._timestamp(t)
        h = env._history
        idx = env.episode_tracker.episode_start_time_step + t

        # ---- community (CityLearnEnv.as_dict, citylearn.py:2651-2676) ----
        bat_bal = h["battery_balance"][t]
        from_storage = (
            np.clip(-bat_bal, 0, None).sum()
            + np.clip(-h["cooling_storage_balance"][t], 0, None).sum()
            + np.clip(-h["heating_storage_balance"][t], 0, None).sum()
            + np.clip(-h["dhw_storage_balance"][t], 0, None).sum())
        self._emit(f"exported_data_community_ep{ep}.csv", {
            "timestamp": ts,
            "Net Electricity Consumption-kWh": float(h["net"][t].sum()),
            "Self Consumption-kWh": float(from_storage),
            "Stored energy by community- kWh":
                float(np.clip(bat_bal, 0, None).sum()),
            "Total Solar Generation-kWh": float(-h["solar"][t].sum()),
            "CO2-kg_co2": float(h["emission"][t].sum()),
            "Price-$": float(h["cost"][t].sum()),
        })

        # the EV SOCs after the step, from the step's one host copy
        ev_socs = env._ev_soc if env.cfg.has_evs else None
        slots, _ = env._charger_action_slots

        for bi, b in enumerate(env.spec.buildings):
            # ---- building (Building.as_dict, building.py:2711-2721) ----
            self._emit(f"exported_data_{b.name.lower()}_ep{ep}.csv", {
                "timestamp": ts,
                "Net Electricity Consumption-kWh": float(h["net"][t, bi]),
                "Non-shiftable Load-kWh": float(b.series["non_shiftable_load"][idx]),
                "Non-shiftable Load Electricity Consumption-kWh":
                    float(h["nsl_cons"][t, bi]),
                "Energy Production from PV-kWh": float(h["solar"][t, bi]),
            })
            # ---- battery (Battery.as_dict, energy_model.py:1228-1235) ----
            self._emit(f"exported_data_{b.name.lower()}_battery_ep{ep}.csv", {
                "timestamp": ts,
                "Battery Soc-%": float(h["battery_soc"][t, bi]),
                "Battery (Dis)Charge-kWh": float(h["battery_balance"][t, bi]),
            })
            # ---- chargers (Charger.as_dict, charger.py:354-413) ----
            for ch in b.chargers:
                ci = slots[f"electric_vehicle_storage_{ch.charger_id}"]
                cons = float(h["charger_cons"][t, ci]) if env.cfg.has_evs else 0.0
                row = {
                    "timestamp": ts,
                    "Charger Consumption-kWh":
                        f"{cons}" if cons > 0 else "-1.00",
                    "Charger Production-kWh":
                        "-1.00" if cons > 0 else f"{abs(cons)}",
                    "Incoming EV Name": "",
                    "Charging Action-kWh":
                        float(h["charger_action_kwh"][t, ci])
                        if env.cfg.has_evs else 0.0,
                }
                conn = int(ch.connected_ev[t]) if ch.connected_ev is not None else -1
                inc = int(ch.incoming_ev[t]) if ch.incoming_ev is not None else -1
                if inc >= 0:
                    row["Incoming EV Name"] = env.spec.electric_vehicles[inc].name
                ev_i = conn if conn >= 0 else inc
                if ev_i >= 0 and ev_socs is not None:
                    row.update({
                        "EV SOC-%": f"{ev_socs[ev_i]:.2f}",
                        "EV Charger State": float(ch.state[t]),
                        "EV Required SOC Departure-%": f"{ch.required_soc[t]}",
                        "EV Estimated SOC Arrival-%":
                            f"{ch.estimated_soc_arrival[t]}",
                        "EV Arrival Time": f"{ch.arrival_time[t]}",
                        "EV Departure Time": f"{ch.departure_time[t]}",
                        "Is EV Connected": True,
                        "EV Name": env.spec.electric_vehicles[ev_i].name,
                    })
                else:
                    row.update({
                        "EV SOC": "-1.00",
                        "EV Charger State": "-1.00",
                        "EV Required SOC Departure-%": "-1.00",
                        "EV Estimated SOC Arrival-%": "-1.00",
                        "EV Arrival Time": "-1.00",
                        "EV Departure Time": "-1.00",
                        "Is EV Connected": False,
                        "EV Name": "",
                    })
                self._emit(
                    f"exported_data_{b.name.lower()}_{ch.charger_id}_ep{ep}.csv",
                    row)

        # ---- pricing (Pricing.as_dict, data.py:629-644) ----
        b0 = env.spec.buildings[0]
        self._emit(f"exported_data_pricing_ep{ep}.csv", {
            "timestamp": ts,
            "electricity_pricing-$/kWh": float(b0.series["electricity_pricing"][idx]),
            "electricity_pricing_predicted_1-$/kWh":
                float(b0.series["electricity_pricing_predicted_1"][idx]),
            "electricity_pricing_predicted_2-$/kWh":
                float(b0.series["electricity_pricing_predicted_2"][idx]),
            "electricity_pricing_predicted_3-$/kWh":
                float(b0.series["electricity_pricing_predicted_3"][idx]),
        })

        # ---- EVs (ElectricVehicle.as_dict, electric_vehicle.py:112-123) ----
        if ev_socs is not None:
            for v, ev in enumerate(env.spec.electric_vehicles):
                self._emit(f"exported_data_{ev.name.lower()}_ep{ep}.csv", {
                    "timestamp": ts,
                    "name": ev.name,
                    "Battery capacity": float(ev.battery.capacity),
                    "electric_vehicle_soc": float(ev_socs[v]),
                })

    def _emit(self, filename: str, row: Mapping):
        if self.mode == "end":
            self._buffer[filename].append(dict(row))
        else:
            self._write(filename, [row])

    def _write(self, filename, rows):
        """Append rows, extending the header in place when new columns
        appear (the reference's grow-the-header rewrite,
        ``citylearn.py:1597-1652``)."""
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, filename)
        new_fields = list(dict.fromkeys(
            f for row in rows for f in row.keys()))
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=new_fields)
                w.writeheader()
                for row in rows:
                    w.writerow({k: row.get(k, "") for k in new_fields})
            return
        with open(path, "r", newline="") as f:
            reader = csv.DictReader(f)
            existing_fields = reader.fieldnames or []
            extra = [c for c in new_fields if c not in existing_fields]
            existing_rows = list(reader) if extra else None
        if not extra:
            with open(path, "a", newline="") as f:
                w = csv.DictWriter(f, fieldnames=existing_fields)
                for row in rows:
                    w.writerow({k: row.get(k, "") for k in existing_fields})
            return
        fields = existing_fields + extra
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            w.writeheader()
            for row in existing_rows:
                w.writerow({k: row.get(k, "") for k in fields})
            for row in rows:
                w.writerow({k: row.get(k, "") for k in fields})

    def flush(self):
        for filename, rows in self._buffer.items():
            if rows:
                self._write(filename, rows)
        self._buffer.clear()

    def export_final_kpis(self, filepath: str = "exported_kpis.csv"):
        """KPI pivot CSV (reference ``citylearn.py:1477-1500``)."""
        kpis = self.env.evaluate()
        pivot = kpis.pivot(index="cost_function", columns="name", values="value")
        pivot = pivot.round(3).dropna(how="all").fillna("").reset_index()
        pivot = pivot.rename(columns={"cost_function": "KPI"})
        os.makedirs(self.directory, exist_ok=True)
        pivot.to_csv(os.path.join(self.directory, filepath), index=False,
                     encoding="utf-8")
