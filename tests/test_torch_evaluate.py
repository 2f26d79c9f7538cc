"""The port's batched KPI tables on the stepped path against the JAX
package's scanned ``evaluate_districts``, for both storage baselines.

Tolerance 1e-5 relative (NaN where JAX gives NaN): every KPI is a ratio
of sums over the episode, taken in another order than XLA's, of series
that already differ in the last bit where XLA:CPU fuses multiply-adds."""

import numpy as np
import pytest

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core.evaluate import evaluate_districts as jax_evaluate
from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxScriptedPolicy
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu.core.rollout import batched_initial_states as jax_states
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

S = 168
RBC = np.where(np.arange(1, 25) < 9, 0.091, -0.08).astype(np.float32)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), 5, 200, seed=4)
    kw = dict(episode_time_steps=S + 1)
    return (pack(compile_schema(path, **kw), device="cpu")[:2],
            jax_pack(jax_compile(path, **kw))[:2])


def assert_tables_close(ours, ref):
    assert set(ours) == set(ref)
    assert len(ours) == 37
    for k in sorted(ours):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("baseline", ["_without_storage", "_without_storage_and_pv"])
@pytest.mark.parametrize("offset,n_steps", [(0, None), (32, S)],
                         ids=["episode", "window_clamped_at_end"])
def test_kpi_table_matches_jax(both, baseline, offset, n_steps):
    """``window_clamped_at_end``: the baseline's extra row runs one past the
    200-row data, where both packages clamp the window start."""
    (cfg, params), (jcfg, jparams) = both
    plan = np.tile(RBC[:, None], (1, 5))
    plan[:, 1] *= 0.5
    plan[:, 3] = -plan[:, 3]
    steps = S if n_steps is None else n_steps
    states = batched_initial_states(cfg, params, 2, offset, device="cpu")
    ours = evaluate_districts(
        cfg, params, states,
        ScriptedPolicy({"electrical_storage": plan}).as_policy_fn(cfg, params, steps),
        n_steps=n_steps, baseline_condition=baseline, device="cpu")
    jpolicy = JaxScriptedPolicy({"electrical_storage": plan})
    ref = jax_evaluate(jcfg, jparams, jax_states(jcfg, jparams, 2, offset),
                       jpolicy.as_policy_fn(jcfg, jparams, steps),
                       n_steps=n_steps, baseline_condition=baseline)
    assert_tables_close(ours, ref)
    assert ours["building|cost_total"].shape == (2, 5)
    assert ours["district|cost_total"].shape == (2,)
    # the control changes the bill; the NaN KPIs are those with no data
    # (no occupants, no outage) in the JAX table too
    assert np.isfinite(ours["district|cost_total"].numpy()).all()
    assert not np.allclose(ours["building|cost_total"].numpy(), 1.0)
