"""The port's thermal physics against the JAX package's, function by
function: heat-pump and heater math (``core/hvac.py``), the storage tank
event (``core/storage.py``) and one end use's device-plus-tank block in
both priority orders (``core/step._thermal_block``).

Inputs are numpy grids that include the edge cases the physics must
survive: outdoor temperature equal to the target (a division by zero the
COP maps to 20), zero-capacity tanks, infinite and finite tank power
caps, empty and full tanks.

Tolerance: 1e-6 relative to each output's scale (with an absolute floor
of 1e-6 of that scale). The JAX functions run through ``jax.jit`` on the
CPU, where XLA contracts ``a + b * c`` into one fused multiply-add while
the port rounds twice; a single event can differ in the last float32 bit
and nothing accumulates here. Non-finite values (an infinite cap passed
through) must agree exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from citylearn_tpu.core import hvac as jax_hvac
from citylearn_tpu.core.step import _thermal_block as jax_thermal_block
from citylearn_tpu.core.storage import tank_charge as jax_tank_charge
from citylearn_tpu.core.types import HVACParams as JaxHVACParams
from citylearn_tpu.core.types import StaticConfig as JaxStaticConfig
from citylearn_tpu.core.types import StorageTankParams as JaxStorageTankParams
from citylearn_tpu_torch.core import hvac
from citylearn_tpu_torch.core.step import _thermal_block
from citylearn_tpu_torch.core.storage import tank_charge
from citylearn_tpu_torch.core.types import HVACParams, StaticConfig, StorageTankParams

B = 8
TARGET_C, TARGET_H = 8.5, 47.5


def assert_close(ours, ref, name):
    ours, ref = ours.numpy(), np.asarray(ref)
    assert ours.shape == ref.shape, name
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(ours[~finite], ref[~finite], err_msg=name)
    scale = float(np.max(np.abs(ref[finite]))) if finite.any() else 1.0
    np.testing.assert_allclose(ours[finite], ref[finite], rtol=1e-6,
                               atol=1e-6 * (scale or 1.0), err_msg=name)


def both(cls, jax_cls, **fields):
    """The same (B,) parameter block for the port and for JAX."""
    return (cls(**{k: torch.tensor(v) for k, v in fields.items()}),
            jax_cls(**{k: jnp.asarray(v) for k, v in fields.items()}))


def devices(seed):
    """Heat pumps and heaters side by side, with varied efficiencies."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, B).astype(np.float32)
    hp = np.arange(B) % 2 == 0
    return both(HVACParams, JaxHVACParams, is_heat_pump=hp, nominal_power=f(0.5, 5.0),
                efficiency=np.where(hp, f(0.2, 0.3), f(0.9, 0.99)).astype(np.float32),
                target_cooling_temperature=np.full(B, TARGET_C, np.float32),
                target_heating_temperature=np.full(B, TARGET_H, np.float32))


def tanks(seed, caps):
    """Tanks with and without capacity; ``caps`` gives finite power caps."""
    rng = np.random.RandomState(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, B).astype(np.float32)
    capacity = f(1.0, 6.0)
    capacity[1] = 0.0                        # an absent tank, efficiency as the compiler defaults it
    efficiency = f(0.9, 0.98)
    efficiency[1] = 0.94
    inf = np.full(B, np.inf, np.float32)
    return both(StorageTankParams, JaxStorageTankParams, capacity=capacity,
                efficiency=efficiency, loss_coefficient=f(0.001, 0.009),
                initial_soc=f(0.0, 1.0),
                max_input_power=f(0.3, 1.5) if caps else inf,
                max_output_power=f(0.3, 1.5) if caps else inf)


def outdoor_grid(heating):
    """(N, B) outdoor temperatures: below, at and above the target."""
    target = TARGET_H if heating else TARGET_C
    t = np.concatenate([np.linspace(-10.0, 60.0, 29), [target, target + 1e-3, target - 1e-3]])
    return np.tile(t.astype(np.float32)[:, None], (1, B))


@pytest.mark.parametrize("heating", [False, True], ids=["cooling", "heating"])
def test_hvac_matches_jax(heating):
    dev, jdev = devices(0)
    outdoor = outdoor_grid(heating)
    rng = np.random.RandomState(1)
    output = rng.uniform(0.0, 8.0, outdoor.shape).astype(np.float32)
    flex = np.where(rng.uniform(size=outdoor.shape) < 0.5, np.inf,
                    rng.uniform(0.0, 3.0, outdoor.shape)).astype(np.float32)
    booked = rng.uniform(0.0, 1.0, outdoor.shape).astype(np.float32)
    t = torch.tensor
    cop = hvac.heat_pump_cop(dev, t(outdoor), heating)
    # the division by zero at outdoor == target maps to 20
    assert torch.isfinite(cop).all() and float(cop.max()) == 20.0 and float(cop.min()) > 0
    assert_close(cop, jax.jit(lambda o: jax_hvac.heat_pump_cop(jdev, o, heating))(outdoor), "cop")
    assert_close(hvac.device_cop(dev, t(outdoor), heating),
                 jax.jit(lambda o: jax_hvac.device_cop(jdev, o, heating))(outdoor),
                 "device_cop")
    assert_close(hvac.input_power(dev, t(output), t(outdoor), heating),
                 jax.jit(lambda x, o: jax_hvac.input_power(jdev, x, o, heating))(output, outdoor),
                 "input_power")
    assert_close(hvac.max_output_power(dev, t(outdoor), heating, t(flex), t(booked)),
                 jax.jit(lambda o, f, c: jax_hvac.max_output_power(jdev, o, heating, f, c))(
                     outdoor, flex, booked), "max_output_power")


@pytest.mark.parametrize("caps", [False, True], ids=["uncapped", "capped"])
def test_tank_charge_matches_jax(caps):
    tank, jtank = tanks(2, caps)
    soc = np.repeat(np.linspace(0.0, 1.0, 6, dtype=np.float32), 9)
    energy = np.tile(np.array([-8.0, -1.0, -0.05, 0.0, 1e-4, 0.05, 0.7, 3.0, 12.0], np.float32), 6)
    soc, energy = (np.tile(x[:, None], (1, B)) for x in (soc, energy))
    ours = tank_charge(tank, torch.tensor(soc), torch.tensor(energy), 1.0)
    ref = jax.jit(lambda s, e: jax_tank_charge(jtank, s, e, 1.0))(soc, energy)
    assert_close(ours.soc, ref.soc, "soc")
    assert_close(ours.energy_balance, ref.energy_balance, "energy_balance")
    # the zero-capacity tank holds nothing and moves nothing
    assert float(ours.soc[:, 1].abs().max()) == 0.0
    assert float(ours.energy_balance[:, 1].abs().max()) == 0.0
    # both directions, the capacity clamp and the empty clamp occur
    assert (ours.energy_balance > 0).any() and (ours.energy_balance < 0).any()
    assert (ours.soc[:, 0] == 1.0).any() and (ours.soc[:, 0] == 0.0).any()


@pytest.mark.parametrize("heating,hours_ratio_applies,t0,outage", [
    (False, False, False, False), (True, True, False, False), (False, False, True, False),
    (True, True, True, False), (False, False, False, True), (True, True, True, True)],
    ids=["cooling", "dhw", "cooling-t0", "dhw-t0", "cooling-outage", "dhw-t0-outage"])
def test_thermal_block_matches_jax(heating, hours_ratio_applies, t0, outage):
    """Both priority orders of one end use: device first then storage
    charge (action >= 0), storage discharge first then device (action < 0),
    including a saturated device (small nominal power), at t == 0 the
    consumption already booked by the reset-time ``update_variables``, and
    under an outage the cap by what PV leaves after the loads booked so far."""
    cfg_kw = dict(n_buildings=B, time_steps=10, central_agent=False,
                  seconds_per_time_step=3600.0, time_step_ratio=1.0,
                  simulate_power_outage=(False,) * B)
    cfg, jcfg = StaticConfig(**cfg_kw), JaxStaticConfig(**cfg_kw)
    dev, jdev = devices(3)
    tank, jtank = tanks(4, caps=True)
    N = 64
    rng = np.random.RandomState(5)
    f = lambda lo, hi: rng.uniform(lo, hi, (N, B)).astype(np.float32)
    soc, demand, action = f(0.0, 1.0), f(0.0, 6.0), f(-1.0, 1.0)
    action[::7] = 0.0
    demand[::5] = 0.0
    outdoor = f(-5.0, 40.0)
    solar = f(0.0, 3.0)
    accum = f(0.0, 2.0)
    booked = f(0.0, 0.4) if t0 else np.zeros((N, B), np.float32)
    conv = rng.uniform(1.0, 6.0, B).astype(np.float32)
    out_mask = (rng.uniform(size=(N, B)) < 0.5) if outage else np.zeros((N, B), bool)
    t = torch.tensor
    (ours, ours_accum) = _thermal_block(
        dev, tank, t(soc), t(demand), t(action), t(outdoor), heating, t(conv),
        hours_ratio_applies, t(out_mask), t(solar), t(accum), t(booked), cfg)
    ref, ref_accum = jax.jit(lambda s, d, a, o, so, ac, bk: jax_thermal_block(
        jdev, jtank, s, d, a, o, heating, jnp.asarray(conv), None, hours_ratio_applies,
        jnp.asarray(out_mask), so, ac, bk, jcfg))(soc, demand, action, outdoor, solar, accum,
                                                   booked)
    for name in ("soc", "balance", "device_output", "apply_consumption"):
        assert_close(getattr(ours, name), getattr(ref, name), name)
    assert_close(ours_accum, ref_accum, "cons_accum")
    # both orders ran, tanks charged and discharged, and a device saturated
    assert (ours.balance[action >= 0] > 0).any() and (ours.balance[action < 0] < 0).any()
    assert (ours.device_output < t(demand) - 1e-3).any()
