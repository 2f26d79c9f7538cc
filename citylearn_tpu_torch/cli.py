"""CLI + batch orchestration (reference ``citylearn/__main__.py``).

Commands mirror the reference:
  - ``citylearn-tpu-torch simulate <schema> train|evaluate [--fast]`` with
    JSON summaries under ``--output_directory``
  - ``citylearn-tpu-torch list_datasets``
  - ``citylearn-tpu-torch run_work_order <file>`` (process-pool shell
    fan-out, kept for compatibility; the batched scale-out is
    :mod:`citylearn_tpu_torch.train`)

Also ``python -m citylearn_tpu_torch.cli``. The env runs on the CUDA card
unless ``--env_kwargs '{"device": "cpu"}'`` says otherwise. ``evaluate
--fast`` runs an open-loop agent's whole episode as one launch of the
family's kernel (:mod:`citylearn_tpu_torch.core.evaluate_fast`).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib
import json
import os
import pickle
import subprocess
import time
import uuid
from multiprocessing import cpu_count
from typing import Any, List, Mapping, Optional, Union

import numpy as np

from citylearn_tpu_torch import __version__
from citylearn_tpu_torch.data import DataSet
from citylearn_tpu_torch.envs.environment import CityLearnEnv

PACKAGE = "citylearn_tpu_torch"
#: the JAX package, whose class paths name the port's classes here
JAX_PACKAGE = "citylearn_tpu"
# dotted-path aliases so reference schemas (citylearn.*) resolve to the
# port's classes
ALIASES = {
    "citylearn.agents": "citylearn_tpu_torch.agents",
    "citylearn.wrappers": "citylearn_tpu_torch.wrappers",
    "citylearn.citylearn": "citylearn_tpu_torch.envs.environment",
}
DEFAULT_AGENT = "citylearn_tpu_torch.agents.base.Agent"

# The reference's ``citylearn/misc/settings.yaml`` variable list — an
# interface contract (existing tooling reads exports keyed by these names,
# reference ``data.py:24`` + ``__main__.py:212-237``). Grouped by source:
# counterfactual nets, per-device consumptions, demands, energy flows,
# COPs, SOCs, temperatures and dotted driver-series paths.
DEFAULT_TIME_SERIES_VARIABLES = [
    "net_electricity_consumption",
    "net_electricity_consumption_without_storage",
    "net_electricity_consumption_without_storage_and_partial_load",
    "net_electricity_consumption_without_storage_and_partial_load_and_pv",
    "solar_generation",
    "cooling_electricity_consumption",
    "heating_electricity_consumption",
    "dhw_electricity_consumption",
    "non_shiftable_load_electricity_consumption",
    "cooling_storage_electricity_consumption",
    "heating_storage_electricity_consumption",
    "dhw_storage_electricity_consumption",
    "electrical_storage_electricity_consumption",
    "cooling_demand",
    "cooling_demand_without_partial_load",
    "heating_demand",
    "heating_demand_without_partial_load",
    "dhw_demand",
    "non_shiftable_load",
    "energy_from_cooling_device",
    "energy_from_heating_device",
    "energy_from_dhw_device",
    "energy_from_cooling_storage",
    "energy_from_heating_storage",
    "energy_from_dhw_storage",
    "energy_from_electrical_storage",
    "energy_from_cooling_device_to_cooling_storage",
    "energy_from_heating_device_to_heating_storage",
    "energy_from_dhw_device_to_dhw_storage",
    "energy_to_non_shiftable_load",
    "energy_to_electrical_storage",
    "cooling_device_cop",
    "heating_device_cop",
    "dhw_device_cop",
    "cooling_storage.soc",
    "heating_storage.soc",
    "dhw_storage.soc",
    "electrical_storage.soc",
    "indoor_dry_bulb_temperature",
    "indoor_dry_bulb_temperature_without_partial_load",
    "energy_simulation.indoor_dry_bulb_temperature_cooling_set_point",
    "energy_simulation.indoor_dry_bulb_temperature_heating_set_point",
    "energy_simulation.occupant_count",
    "pricing.electricity_pricing",
    "carbon_intensity.carbon_intensity",
    "energy_simulation.power_outage",
    "weather.outdoor_dry_bulb_temperature",
    "weather.outdoor_relative_humidity",
]


def get_settings() -> dict:
    """Package settings (the reference reads these from
    ``citylearn/misc/settings.yaml``; ``data.py:24``)."""
    return {"default_time_series_variables": list(DEFAULT_TIME_SERIES_VARIABLES)}


def _port_module(module: str) -> str:
    """The port's module for a dotted module path: ``citylearn_tpu.*``
    (the JAX package) and the reference's ``citylearn.agents``,
    ``citylearn.wrappers`` and ``citylearn.citylearn`` map onto
    ``citylearn_tpu_torch``; agent submodules map flat
    (``citylearn.agents.rbc`` -> ``citylearn_tpu_torch.agents.rbc``)."""
    within = lambda prefix: module == prefix or module.startswith(prefix + ".")
    if within(PACKAGE):
        return module
    if within(JAX_PACKAGE):
        return PACKAGE + module[len(JAX_PACKAGE):]
    for ref, mine in ALIASES.items():
        if within(ref):
            return mine + module[len(ref):]
    return module


def resolve_class(dotted: str):
    """The class at a dotted path, the JAX package's and the reference's
    paths resolved to the port's classes; never imports the JAX package."""
    module, name = dotted.rsplit(".", 1)
    return getattr(importlib.import_module(_port_module(module)), name)


class Simulator:
    """Train/evaluate wrapper with JSON summaries (reference
    ``__main__.py:69-385``)."""

    def __init__(self, schema: str, agent_name: str = None,
                 env_kwargs: Mapping[str, Any] = None,
                 agent_kwargs: Mapping[str, Any] = None,
                 wrappers: List[str] = None,
                 time_series_variables: List[str] = None,
                 simulation_id: str = None,
                 output_directory: Union[str, os.PathLike] = None,
                 agent_filepath: str = None, random_seed: int = None,
                 overwrite: bool = None):
        self.schema = schema
        self.agent_name = agent_name or DEFAULT_AGENT
        self.env_kwargs = dict(env_kwargs or {})
        self.agent_kwargs = dict(agent_kwargs or {})
        self.wrappers = wrappers or []
        self.time_series_variables = (time_series_variables
                                      or DEFAULT_TIME_SERIES_VARIABLES)
        self.simulation_id = simulation_id or uuid.uuid4().hex[:8]
        self.output_directory = str(output_directory or "citylearn_simulations")
        self.agent_filepath = agent_filepath
        if random_seed is not None:
            self.env_kwargs["random_seed"] = random_seed
        os.makedirs(self.output_directory, exist_ok=True)
        self._set_env()
        self._set_agent()
        self._timestamps = {}

    def _set_env(self):
        schema = self.schema
        if isinstance(schema, str) and not os.path.exists(schema):
            schema = DataSet().get_schema_path(schema)
        self.env = CityLearnEnv(schema, **self.env_kwargs)
        for w in self.wrappers:
            self.env = resolve_class(w)(self.env)

    def _set_agent(self):
        if self.agent_filepath:
            with open(self.agent_filepath, "rb") as f:
                self.agent = pickle.load(f)
            self.agent.env = self.env
        else:
            self.agent = resolve_class(self.agent_name)(self.env, **self.agent_kwargs)

    def _unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    # ------------------------------------------------------------------
    @classmethod
    def train(cls, episodes: int = None, evaluate: bool = None,
              evaluation_episode_time_steps=None, save_agent: bool = None,
              **kwargs):
        sim = cls(**kwargs)
        episodes = 1 if episodes is None else int(episodes)
        sim._timestamps["train_start"] = time.time()
        sim.agent.learn(episodes=episodes)
        sim._timestamps["train_end"] = time.time()
        path = os.path.join(sim.output_directory, f"{sim.simulation_id}-train.json")
        with open(path, "w") as f:
            json.dump(sim._training_summary(), f, indent=2, default=float)
        if save_agent:
            with open(os.path.join(sim.output_directory,
                                   f"{sim.simulation_id}-agent.pkl"), "wb") as f:
                pickle.dump(sim.agent, f)
        if evaluate:
            cls.evaluate(
                evaluation_episode_time_steps=evaluation_episode_time_steps,
                _existing=sim, **kwargs)
        return sim

    @classmethod
    def evaluate(cls, evaluation_episode_time_steps=None, _existing=None,
                 fast: bool = False, **kwargs):
        """Deterministic evaluation episode + KPI/time-series JSON.

        ``fast=True`` routes kernel-eligible configurations under
        open-loop agents (hour-RBC family, Baseline) through the
        whole-episode kernels
        (:mod:`citylearn_tpu_torch.core.evaluate_fast`) on the env's
        device: the episode is ONE kernel launch instead of T host-driven
        env steps. The KPI pivot
        is the full normalized table; the exported time series are
        limited to the kernel-recorded streams (net consumption, storage
        SOCs/consumptions, device outputs)."""
        if _existing is None:
            if evaluation_episode_time_steps is not None:
                kwargs.setdefault("env_kwargs", {})
                kwargs["env_kwargs"]["episode_time_steps"] = \
                    [list(evaluation_episode_time_steps)]
            sim = cls(**kwargs)
        else:
            sim = _existing
        sim._timestamps["evaluation_start"] = time.time()
        if fast:
            summary = sim._fast_evaluation_summary()
        else:
            sim.agent.learn(episodes=1, deterministic=True)
            summary = None
        sim._timestamps["evaluation_end"] = time.time()
        if summary is None:
            summary = sim._evaluation_summary()
        else:
            summary["evaluation_start_timestamp"] = \
                sim._timestamps.get("evaluation_start")
            summary["evaluation_end_timestamp"] = \
                sim._timestamps.get("evaluation_end")
        path = os.path.join(sim.output_directory,
                            f"{sim.simulation_id}-evaluation.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=2, default=float)
        return sim

    # ------------------------------------------------------------------
    def _reward_summary(self):
        env = self._unwrapped()
        rewards = np.array(env.rewards[1:], dtype=float) if len(env.rewards) > 1 \
            else np.zeros((0, 1))
        if rewards.size == 0:
            return {}
        return {"min": rewards.min(axis=0).tolist(),
                "max": rewards.max(axis=0).tolist(),
                "sum": rewards.sum(axis=0).tolist(),
                "mean": rewards.mean(axis=0).tolist()}

    def _training_summary(self):
        return {
            "simulation_id": self.simulation_id,
            "schema": str(self.schema),
            "agent": self.agent_name,
            "train_start_timestamp": self._timestamps.get("train_start"),
            "train_end_timestamp": self._timestamps.get("train_end"),
            "reward_summary": self._reward_summary(),
            "env_metadata": self._unwrapped().get_metadata(),
        }

    def _time_series(self):
        """Dotted-path variable resolution over the live building views
        (reference ``__main__.py:212-237``): each entry of
        ``time_series_variables`` walks ``getattr`` segments on the
        building (``cooling_storage.soc`` etc.). Only fully-resolved leaf
        arrays are exported — a deliberate divergence from the reference,
        whose silent ``pass`` carries the *previous* variable's value into
        a column whose path fails partway (and exports intermediate
        container objects on partial resolution)."""
        env = self._unwrapped()
        n = env.time_step + 1
        out = {}
        for b in env.buildings:
            series = {}
            for variable in self.time_series_variables:
                key = b
                resolved = True
                for seg in variable.split("."):
                    if hasattr(key, seg):
                        key = getattr(key, seg)
                    else:
                        resolved = False
                        break
                if not resolved:
                    continue
                arr = np.asarray(key, np.float64)[:n]
                series[variable.replace(".", "_")] = arr.tolist()
            out[b.name] = series
        return out

    def _fast_evaluation_summary(self):
        """KPI pivot + kernel-recorded time series from ONE whole-episode
        kernel launch on the env's device (no host-driven stepping).
        Requires a kernel-eligible configuration and an open-loop agent."""
        from citylearn_tpu_torch.agents.base import BaselineAgent
        from citylearn_tpu_torch.agents.rbc import HourRBC
        from citylearn_tpu_torch.core.evaluate_fast import (
            ScriptedPolicy,
            evaluate_scripted,
            kernel_family,
        )
        from citylearn_tpu_torch.ops import ev as ev_ops
        from citylearn_tpu_torch.ops import lstm as lstm_ops
        from citylearn_tpu_torch.ops import neighborhood as nb_ops
        from citylearn_tpu_torch.ops import thermal as th_ops

        env = self._unwrapped()
        cfg, params = env.cfg, env.params
        family = kernel_family(cfg)
        if family is None:
            raise ValueError(
                "--fast requires a kernel-eligible configuration "
                "(battery+PV, thermal, LSTM-dynamics, EV or neighborhood family; see "
                "core/rollout_fast.eligible_* — per-family data-level limits such as "
                "lane-packing bounds are excluded); run without --fast "
                "for the general path")
        offset = int(getattr(env, "_offset", 0))
        if offset != 0 and cfg.has_stochastic_outage:
            raise ValueError(
                "--fast on a shifted window of a stochastic-outage "
                "dataset is unsupported (signal baked per default "
                "window) — run without --fast")
        agent = self.agent
        if isinstance(agent, HourRBC) and agent.action_map is not None:
            policy = ScriptedPolicy.from_hour_rbc(agent, cfg.n_buildings, spec=env.spec)
        elif isinstance(agent, BaselineAgent):
            policy = ScriptedPolicy({})
        else:
            raise ValueError(
                "--fast requires an open-loop agent (hour-RBC family or "
                "Baseline); closed-loop policies need the general path")

        # default baseline condition matches the host evaluate(): dynamics
        # buildings normalize against the no-storage-and-ideal-load
        # baseline (citylearn.py:1194-1201)
        baseline = ("_without_storage_and_partial_load"
                    if cfg.has_dynamics else "_without_storage")
        table, rec = evaluate_scripted(cfg, params, policy, baseline_condition=baseline,
                                       return_series=True, data_offset=offset,
                                       device=env.device)
        rec = rec.double().cpu().numpy()

        names = [b.name for b in env.buildings]
        pivot = {}
        for key, v in table.items():
            level, kpi = key.split("|")
            v = v.double().cpu().numpy()
            d = pivot.setdefault(kpi, {})
            if level == "building":
                for i, n in enumerate(names):
                    x = float(v[i])
                    d[n] = None if np.isnan(x) else x
            else:
                x = float(v)
                d["District"] = None if np.isnan(x) else x

        # time series: kernel-recorded control streams; the final,
        # never-written episode row reads 0 like the host's preallocated
        # arrays (envs/views.py _hist semantics)
        ser = params.series
        S = rec.shape[1]
        fin = lambda col: np.concatenate([col, [0.0]]).tolist()
        # the demand/demand-met histories' final unwritten row reads the
        # DATA demand (envs/environment._sync_unwritten_row)
        data_end = lambda arr, i: arr[offset + S:offset + S + 1, i].double().cpu().numpy()
        fin_d = lambda col, arr, i: np.concatenate([col, data_end(arr, i)]).tolist()
        nsl = ser.non_shiftable_load[offset:offset + S + 1].double().cpu().numpy()
        series_out = {}
        for i, n in enumerate(names):
            if family in ("battery", "ev"):
                # K1 records net, battery balance and SOC in rows 0-2
                rows = ((ev_ops.R_NET, ev_ops.R_BBAL, ev_ops.R_BSOC) if family == "ev"
                        else (0, 1, 2))
                net, bal, soc = (rec[r, :, i] for r in rows)
                cols = {
                    "net_electricity_consumption": fin(net),
                    "electrical_storage_electricity_consumption":
                        fin(np.concatenate([[2 * bal[0]], bal[1:]])),
                    "electrical_storage_soc": fin(soc),
                    "energy_from_electrical_storage": fin(np.maximum(-bal, 0.0)),
                    "energy_to_electrical_storage": fin(np.maximum(bal, 0.0)),
                }
            elif family == "neighborhood":
                bal = rec[nb_ops.R_BBAL, :, i]
                cols = {
                    "net_electricity_consumption": fin(rec[nb_ops.R_NET, :, i]),
                    "electrical_storage_electricity_consumption":
                        fin(np.concatenate([[2 * bal[0]], bal[1:]])),
                    "electrical_storage_soc": fin(rec[nb_ops.R_BSOC, :, i]),
                    "dhw_storage_soc": fin(rec[nb_ops.R_DSOC, :, i]),
                    "energy_from_cooling_device":
                        fin_d(rec[nb_ops.R_COUT, :, i], ser.cooling_demand, i),
                    "energy_from_heating_device":
                        fin_d(rec[nb_ops.R_HOUT, :, i], ser.heating_demand, i),
                    "energy_from_dhw_device":
                        fin_d(rec[nb_ops.R_DOUT, :, i], ser.dhw_demand, i),
                    "cooling_demand": fin_d(rec[nb_ops.R_CDEM, :, i], ser.cooling_demand, i),
                    "heating_demand": fin_d(rec[nb_ops.R_HDEM, :, i], ser.heating_demand, i),
                }
            else:
                # the thermal and LSTM kernels share the first nine
                # record-row indices (net, balances, SOCs, outputs)
                bal = rec[th_ops.R_BBAL, :, i]
                cols = {
                    "net_electricity_consumption": fin(rec[th_ops.R_NET, :, i]),
                    "electrical_storage_electricity_consumption":
                        fin(np.concatenate([[2 * bal[0]], bal[1:]])),
                    "electrical_storage_soc": fin(rec[th_ops.R_BSOC, :, i]),
                    "cooling_storage_soc": fin(rec[th_ops.R_CSOC, :, i]),
                    "dhw_storage_soc": fin(rec[th_ops.R_DSOC, :, i]),
                    "energy_from_cooling_device":
                        fin_d(rec[th_ops.R_COUT, :, i], ser.cooling_demand, i),
                    "energy_from_dhw_device":
                        fin_d(rec[th_ops.R_DOUT, :, i], ser.dhw_demand, i),
                    "energy_from_cooling_storage":
                        fin(np.maximum(-rec[th_ops.R_CBAL, :, i], 0.0)),
                    "energy_from_dhw_storage":
                        fin(np.maximum(-rec[th_ops.R_DBAL, :, i], 0.0)),
                }
                if family == "lstm":
                    cols["indoor_dry_bulb_temperature"] = fin_d(
                        rec[lstm_ops.R_TEMP, :, i], ser.indoor_dry_bulb_temperature, i)
                    cols["cooling_demand"] = fin_d(rec[lstm_ops.R_CDEM, :, i],
                                                   ser.cooling_demand, i)
            cols["non_shiftable_load"] = nsl[:, i].tolist()
            series_out[n] = cols

        return {
            "simulation_id": self.simulation_id,
            "kpis": pivot,
            "time_series": series_out,
        }

    def _evaluation_summary(self):
        """KPI pivot of the env's rows (numpy, no pandas) and its time series."""
        env = self._unwrapped()
        pivot = {}
        for r in env.evaluate_rows():
            v = r["value"]
            pivot.setdefault(r["cost_function"], {})[r["name"]] = \
                None if v is None or (isinstance(v, float) and np.isnan(v)) else v
        return {
            "simulation_id": self.simulation_id,
            "evaluation_start_timestamp": self._timestamps.get("evaluation_start"),
            "evaluation_end_timestamp": self._timestamps.get("evaluation_end"),
            "kpis": pivot,
            "time_series": self._time_series(),
        }


def run_work_order(work_order_filepath, max_workers=None, start_index=None,
                   end_index=None):
    """Process-pool shell fan-out (reference ``__main__.py:31-67``)."""
    with open(work_order_filepath) as f:
        lines = [l for l in f.read().strip("\n").split("\n")
                 if l and not l.startswith("#")]
    start_index = 0 if start_index is None else start_index
    end_index = len(lines) - 1 if end_index is None else end_index
    lines = lines[start_index:end_index + 1]
    max_workers = cpu_count() if max_workers is None else max_workers
    with concurrent.futures.ProcessPoolExecutor(max_workers=max_workers) as ex:
        futures = [ex.submit(subprocess.run, args=l, shell=True) for l in lines]
        for f in concurrent.futures.as_completed(futures):
            f.result()


def main(argv: Optional[List[str]] = None):
    """Run one command line (``sys.argv[1:]`` when ``argv`` is None)."""
    parser = argparse.ArgumentParser(
        prog="citylearn-tpu-torch",
        description="CityLearn on PyTorch and CUDA: district energy demand-response RL")
    parser.add_argument("--version", action="version",
                        version=f"%(prog)s {__version__}")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("list_datasets")

    p = sub.add_parser("run_work_order")
    p.add_argument("work_order_filepath")
    p.add_argument("-w", "--max_workers", type=int)
    p.add_argument("-is", "--start_index", type=int)
    p.add_argument("-ie", "--end_index", type=int)

    p = sub.add_parser("simulate")
    p.add_argument("schema")
    p.add_argument("mode", choices=["train", "evaluate"])
    p.add_argument("-a", "--agent_name", default=None)
    p.add_argument("-e", "--episodes", type=int, default=1)
    p.add_argument("-id", "--simulation_id", default=None)
    p.add_argument("-d", "--output_directory", default=None)
    p.add_argument("-k", "--env_kwargs", type=json.loads, default=None)
    p.add_argument("-ak", "--agent_kwargs", type=json.loads, default=None)
    p.add_argument("-w", "--wrappers", nargs="*", default=None)
    p.add_argument("-rs", "--random_seed", type=int, default=None)
    p.add_argument("-fa", "--agent_filepath", default=None)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--save_agent", action="store_true")
    p.add_argument("--fast", action="store_true",
                   help="evaluate on the whole-episode kernel "
                        "(kernel-eligible configs + open-loop agents only)")

    args = parser.parse_args(argv)
    if args.command == "list_datasets":
        print("\n".join(DataSet().get_dataset_names()))
    elif args.command == "run_work_order":
        run_work_order(args.work_order_filepath, args.max_workers,
                       args.start_index, args.end_index)
    elif args.command == "simulate":
        common = dict(schema=args.schema, agent_name=args.agent_name,
                      env_kwargs=args.env_kwargs, agent_kwargs=args.agent_kwargs,
                      wrappers=args.wrappers, simulation_id=args.simulation_id,
                      output_directory=args.output_directory,
                      random_seed=args.random_seed,
                      agent_filepath=args.agent_filepath)
        if args.mode == "train":
            Simulator.train(episodes=args.episodes, evaluate=args.evaluate,
                            save_agent=args.save_agent, **common)
        else:
            Simulator.evaluate(fast=args.fast, **common)


if __name__ == "__main__":
    main()
