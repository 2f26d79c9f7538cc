"""Battery physics of the port — the reference curve lookup and one
charge/discharge event — against the JAX package's over a grid of SOC,
action and curve inputs, in the pattern of tests/test_battery_unit.py."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.core.battery import battery_charge as jax_battery_charge
from citylearn_tpu.core.curves import interp_reference as jax_interp
from citylearn_tpu.core.types import BatteryParams as JaxBatteryParams
from citylearn_tpu_torch.compiler.seeding import pad_curve
from citylearn_tpu_torch.core.battery import battery_charge
from citylearn_tpu_torch.core.curves import interp_reference
from citylearn_tpu_torch.core.types import BatteryParams

CURVES = {
    "phase1_pec": [[0, 0.83], [0.3, 0.83], [0.7, 0.9], [0.8, 0.9], [1, 0.85]],
    "phase1_cpc": [[0.0, 1], [0.8, 1], [1.0, 0.2]],
    "default_pec": [[0.0, 0.80], [0.3, 0.85], [0.7, 0.92], [0.8, 0.94], [1.0, 0.90]],
    "two_knots": [[0.0, 0.9], [1.0, 0.95]],
}


@pytest.mark.parametrize("name", sorted(CURVES))
def test_interp_equals_jax(name):
    """Exact equality: both sides do the same float32 elementwise math
    (compare, gather, sub, mul, div, add — no multiply-add to contract).
    The grid covers knots exactly, between knots, below 0 (first segment
    extrapolated) and above the last knot (the all-False fallback to
    segment 0)."""
    x, y = pad_curve(CURVES[name], 12)
    q = np.concatenate([np.linspace(-0.5, 1.5, 401), x]).astype(np.float32)
    B = q.shape[0]
    xs = np.broadcast_to(x.astype(np.float32), (B, 12))
    ys = np.broadcast_to(y.astype(np.float32), (B, 12))
    ours = interp_reference(torch.tensor(q), torch.tensor(xs.copy()), torch.tensor(ys.copy()))
    ref = jax.jit(jax_interp)(jnp.asarray(q), jnp.asarray(xs), jnp.asarray(ys))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _params(n, capacity, nominal, efficiency, loss, dod, clc, pec, cpc):
    px, py = pad_curve(pec, 12)
    cx, cy = pad_curve(cpc, 12)
    cols = dict(capacity=capacity, nominal_power=nominal, efficiency=efficiency,
                loss_coefficient=loss, initial_soc=0.0, depth_of_discharge=dod,
                capacity_loss_coefficient=clc)
    arrs = {k: np.full(n, v, np.float32) for k, v in cols.items()}
    for k, v in dict(power_efficiency_curve_x=px, power_efficiency_curve_y=py,
                     capacity_power_curve_x=cx, capacity_power_curve_y=cy).items():
        arrs[k] = np.broadcast_to(v.astype(np.float32), (n, 12)).copy()
    ours = BatteryParams(**{k: torch.tensor(v) for k, v in arrs.items()})
    ref = JaxBatteryParams(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return ours, ref


@pytest.mark.parametrize("capacity,nominal,efficiency,loss,dod,clc,ratio", [
    (6.4, 5.0, 0.9, 0.0, 1.0, 1e-5, 1.0),        # phase-1 battery
    (10.0, 2.5, 0.95, 0.006, 0.8, 1e-4, 1.0),     # standby loss, DoD floor
    (4.0, 6.0, 0.92, 0.002, 0.9, 5e-5, 0.25),     # 15-minute steps
    (0.0, 0.0, 0.94, 0.005, 1.0, 1e-5, 1.0),      # null battery
])
def test_battery_charge_equals_jax(capacity, nominal, efficiency, loss, dod, clc, ratio):
    """Over a grid of SOC, previous efficiency, degraded capacity and
    requested energy. Tolerance 1e-6 relative (atol 1e-6): XLA:CPU
    contracts ``energy_init + e * rt`` and ``deg - x * ratio`` into fused
    multiply-adds rounded once, where the port rounds the product and the
    sum separately, so results may differ in the last float32 bit."""
    soc = np.linspace(0.0, 1.0, 11)
    eff = [0.8, efficiency]
    deg_frac = [1.0, 0.7]
    energy = np.linspace(-1.5, 1.5, 13) * max(nominal, 1.0)
    grid = np.array(list(itertools.product(soc, eff, deg_frac, energy)), np.float32)
    n = grid.shape[0]
    bp, jbp = _params(n, capacity, nominal, efficiency, loss, dod, clc,
                      CURVES["phase1_pec"], CURVES["phase1_cpc"])
    args = [grid[:, 0], grid[:, 1], grid[:, 2] * capacity, grid[:, 3] / ratio]
    ours = battery_charge(bp, *[torch.tensor(a) for a in args], ratio)
    ref = jax.jit(lambda *a: jax_battery_charge(jbp, *a, ratio))(*[jnp.asarray(a) for a in args])
    for name, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                   err_msg=name)
    if capacity > 0:
        # the grid exercises both branches and the capacity clamp
        assert (ours.energy_balance > 0).any() and (ours.energy_balance < 0).any()
        assert float(ours.soc.max()) > 0.99
    else:
        assert not ours.energy_balance.any()
