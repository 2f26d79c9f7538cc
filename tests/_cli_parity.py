"""Helpers of the CLI tests (``tests/test_torch_cli*.py``): one
``simulate <schema> evaluate`` through the port's and the JAX package's
``Simulator``, and comparisons of the JSON summaries they write.

Tolerances: KPI values within 1e-5 of ``max(1, |ref|)`` (the env tests'
tolerance), the comfort KPIs of the dynamics districts included; time
series within 1e-5 of each column's scale."""

import json
import os

import numpy as np

from citylearn_tpu.cli import Simulator as JaxSimulator
from citylearn_tpu_torch.cli import Simulator

TOL = 1e-5


def evaluate(out, schema, agent, rows, fast, port=True, sid=None, **kw):
    """The summary dict of one evaluation episode of ``rows`` rows."""
    sid = sid or f"{'port' if port else 'jax'}-{'fast' if fast else 'stepped'}"
    env_kwargs = dict(kw.pop("env_kwargs", {}), episode_time_steps=rows)
    if port:
        env_kwargs["device"] = "cpu"
    (Simulator if port else JaxSimulator).evaluate(
        schema=schema, agent_name=agent, env_kwargs=env_kwargs, simulation_id=sid,
        output_directory=out, fast=fast, **kw)
    return load(out, sid)


def load(out, sid):
    with open(os.path.join(out, f"{sid}-evaluation.json")) as f:
        return json.load(f)


def assert_pivots_close(ours, ref, tol=TOL):
    """The same KPIs and names, None where the other is None, values
    within ``tol``; returns the number of values compared."""
    assert sorted(ours) == sorted(ref)
    n = 0
    for kpi, cols in ref.items():
        assert sorted(ours[kpi]) == sorted(cols), kpi
        for name, w in cols.items():
            v = ours[kpi][name]
            assert (v is None) == (w is None), (kpi, name, v, w)
            if w is not None:
                n += 1
                assert abs(v - w) <= tol * max(1.0, abs(w)), (kpi, name, v, w)
    return n


def assert_series_close(ours, ref, tol=TOL):
    """The same buildings and columns, each within ``tol`` of its scale."""
    assert sorted(ours) == sorted(ref)
    for b, cols in ref.items():
        assert sorted(ours[b]) == sorted(cols), b
        for c in cols:
            x, y = np.asarray(ours[b][c], np.float64), np.asarray(cols[c], np.float64)
            assert x.shape == y.shape, (b, c)
            scale = max(1.0, float(np.max(np.abs(y), initial=0.0)))
            err = float(np.max(np.abs(x - y), initial=0.0))
            assert err <= tol * scale, (b, c, err)


def check_family(out, schema, agent, rows):
    """``evaluate`` with and without ``--fast`` on both packages: each of
    the port's pivots against JAX's, the port's fast pivot against its
    stepped one, the time series of each mode against JAX's, and the fast
    run's kernel-recorded columns against the same columns of the stepped
    run."""
    runs = {(port, fast): evaluate(out, schema, agent, rows, fast, port=port)
            for port in (True, False) for fast in (True, False)}
    for fast in (True, False):
        n = assert_pivots_close(runs[True, fast]["kpis"], runs[False, fast]["kpis"])
        assert n >= 20
        assert_series_close(runs[True, fast]["time_series"], runs[False, fast]["time_series"])
    assert_pivots_close(runs[True, True]["kpis"], runs[True, False]["kpis"])
    fast, stepped = runs[True, True]["time_series"], runs[True, False]["time_series"]
    assert_series_close(fast, {b: {c: stepped[b][c] for c in fast[b]} for b in fast})
    return runs
