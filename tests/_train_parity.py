"""Shared pieces of the trainer parity tests (``tests/test_torch_train_*.py``
and ``tests/test_torch_marlisa.py``): the port's and the JAX package's
trainers built alike at a small size, the JAX trainer's random numbers fed
into the port, and comparisons of construction, state and KPI tables.

Tolerances, as for each family's stepped district
(``tests/test_torch_step*.py``): physics state, replay rows and rewards
within 1e-5 of their scale (XLA:CPU contracts ``a + b * c`` where the port
rounds twice, and its sine and cosine differ in the encoder); the LSTM's
carry and input buffers, the occupant's previous temperature and, on
districts under the ComfortReward, the reward within 2e-4 relative plus
5e-3 absolute (the JAX package's own tolerance between its LSTM kernel and
its scan), with at most 2 reward entries across a comfort threshold;
integer and boolean state, actions and the occupant's overrides exactly.
KPI tables: 1e-5 relative to max(|value|, 1), the KPIs that count or
average steps beyond a comfort threshold within 2 steps in S."""

import dataclasses

import jax
import numpy as np
import torch

from citylearn_tpu_torch.core.types import EnvState
from citylearn_tpu_torch.train import StepDraws

D, EPISODE, WARM = 4, 48, 60        # 47 steps an episode: one reset in WARM steps
BASE = dict(n_districts=D, hidden=(16, 16), batch_size=16, replay_capacity=D * 64)
LSTM_RTOL, LSTM_ATOL = 2e-4, 5e-3
LOOSE_FIELDS = {"lstm_h", "lstm_c", "dyn_input", "occ_prev_temp"}
EXACT_FIELDS = {"t", "data_offset", "wm_initiated", "occ_hold_counter", "occ_csp_override",
                "occ_hsp_override"}
COMFORT = ("discomfort", "one_minus_thermal_resilience")


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_trainer(schema, marlisa=False, episode=EPISODE, trainer_kw=None, **kw):
    from citylearn_tpu.train import BatchedSAC, TrainConfig
    from citylearn_tpu.train_marlisa import BatchedMARLISA

    cls = BatchedMARLISA if marlisa else BatchedSAC
    return cls(schema, TrainConfig(collect="scan", **dict(BASE, **kw)),
               random_seed=0, episode_time_steps=episode, **(trainer_kw or {}))


def port_trainer(schema, marlisa=False, episode=EPISODE, trainer_kw=None, **kw):
    from citylearn_tpu_torch import BatchedMARLISA, BatchedSAC, TrainConfig

    cls = BatchedMARLISA if marlisa else BatchedSAC
    return cls(schema, TrainConfig(**dict(BASE, **kw)), random_seed=0,
               episode_time_steps=episode, device="cpu", **(trainer_kw or {}))


class FedDraws(StepDraws):
    """The JAX trainer's exploration actions (indexed by step) and window
    offsets (by purpose); the other draws are the port's own."""

    def __init__(self, actions=None, offsets=None):
        super().__init__(0, torch.device("cpu"))
        self.actions, self.fed_offsets = actions, offsets or {}

    def explore(self, t, low, high, n):
        return torch.tensor(np.asarray(self.actions[t]))

    def offsets(self, t, purpose, n, max_offset):
        return torch.tensor(np.asarray(self.fed_offsets[purpose]))


def eval_offsets(ref):
    """The window offsets of the JAX trainer's next ``evaluate``."""
    base = getattr(ref.state, "base", ref.state)
    return ref._draw_offsets(jax.random.fold_in(base.key, 1), ref.cfg.n_districts)


def acting_nets(nets):
    """JAX networks whose policy acts: the mean head scaled up."""
    policy = dict(nets.policy, mean={"w": nets.policy["mean"]["w"] * 300.0,
                                     "b": nets.policy["mean"]["b"]})
    return nets._replace(policy=policy)


def assert_close(ours, ref, name, rtol=1e-5, atol=0.0, allow=0):
    """Within ``rtol`` of |ref| plus ``rtol`` of ref's scale plus ``atol``,
    apart from at most ``allow`` entries."""
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    if ours.size == 0:
        return
    if ours.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(ours, ref, err_msg=name)
        return
    scale = float(np.nanmax(np.abs(ref), initial=0.0)) or 1.0
    bad = ~(np.abs(ours - ref) <= rtol * np.abs(ref) + rtol * scale + atol)
    bad &= ~(np.isnan(ours) & np.isnan(ref))
    assert int(bad.sum()) <= allow, (name, int(bad.sum()), float(np.nanmax(np.abs(ours - ref))))


def assert_construction_matches(ours, ref):
    """Widths, window range, action bounds, mask and routing, the encoder
    stack exactly; the encoded observation table within 1e-6."""
    assert (ours.obs_dim, ours.act_dim, ours.enc_dim, ours.max_offset) == \
        (ref.obs_dim, ref.act_dim, ref.enc_dim, ref.max_offset)
    for f in ("act_low", "act_high", "act_mask", "action_scale", "action_bias", "w_bld",
              "w_ch", "w_wm"):
        a, b = getattr(ours, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    for f in ("src", "kind", "p1", "p2"):
        np.testing.assert_array_equal(getattr(ours.enc_stack, f).numpy(),
                                      np.asarray(getattr(ref.enc_stack, f)), err_msg=f)
    from citylearn_tpu.core.obs_encoder import encode_obs

    obs_static = ref.params.obs_static
    table = jax.vmap(lambda row: jax.vmap(encode_obs)(ref.enc_stack, row))(obs_static)
    np.testing.assert_allclose(ours._enc_table.numpy(),
                               np.asarray(table).reshape(obs_static.shape[0], -1),
                               rtol=0, atol=1e-6)
    base, jbase = ours.base_state, getattr(ref.state, "base", ref.state)
    for f in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done"):
        assert tuple(getattr(base, f).shape) == getattr(jbase, f).shape, f


def assert_env_states_close(ours: EnvState, ref):
    """Every field of the carried district state."""
    for f in dataclasses.fields(EnvState):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        assert not isinstance(a, tuple) or len(a) == len(b), f.name
        for i, (x, y) in enumerate(pairs):
            name = f"env_state.{f.name}[{i}]"
            if f.name in EXACT_FIELDS:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)
            elif f.name in LOOSE_FIELDS:
                assert_close(x, y, name, rtol=LSTM_RTOL, atol=LSTM_ATOL)
            else:
                assert_close(x, y, name)


def assert_train_states_close(ours, ref, comfort=False):
    """Replay, position, step, carried observations and district state of
    a port ``TrainState`` and a JAX one (as numpy); ``replay_act`` bit-equal."""
    assert (int(ours.step), int(ours.replay_pos), bool(ours.replay_full)) == \
        (int(ref.step), int(ref.replay_pos), bool(ref.replay_full))
    np.testing.assert_array_equal(ours.replay_act.numpy(), ref.replay_act)
    for f in ("cur_obs", "replay_obs", "replay_next", "replay_done"):
        assert_close(getattr(ours, f), getattr(ref, f), f)
    if comfort:
        assert_close(ours.replay_rew, ref.replay_rew, "replay_rew", rtol=LSTM_RTOL,
                     atol=LSTM_ATOL, allow=2)
    else:
        assert_close(ours.replay_rew, ref.replay_rew, "replay_rew")
    assert_env_states_close(ours.env_state, ref.env_state)


def assert_tables_match(ours, ref, n_steps, comfort_steps=2):
    """KPI tables: the same 37 KPIs, NaN where and only where the
    reference has it, within 1e-5 of max(|value|, 1); the comfort KPIs
    within ``comfort_steps`` steps in ``n_steps``."""
    assert set(ours) == set(ref) and len(ours) == 37
    for k in sorted(ours):
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), k
        finite = ~np.isnan(b)
        err = float((np.abs(a - b)[finite] / np.maximum(np.abs(b[finite]), 1.0)).max(initial=0))
        tol = 1e-5 + (comfort_steps / n_steps if k.split("|")[1].startswith(COMFORT) else 0.0)
        assert err <= tol, (k, err)


HOURS = np.arange(1, 25)
NIGHT = np.where((HOURS >= 22) | (HOURS <= 8), 0.091, -0.08).astype(np.float32)


def assert_scripted_takes_the_kernel_path(tr, plans, monkeypatch, n_steps=24):
    """``evaluate(policy=ScriptedPolicy)`` on fresh districts dispatches to
    the family's whole-episode kernel path: one ``evaluate_scripted`` call,
    whose table every district gets."""
    from citylearn_tpu_torch.core import evaluate_fast
    from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy

    shipped, calls = evaluate_fast.evaluate_scripted, []
    monkeypatch.setattr(evaluate_fast, "evaluate_scripted",
                        lambda *a, **kw: calls.append(a) or shipped(*a, **kw))
    policy = ScriptedPolicy(plans, hour_tables=True)
    table = tr.evaluate(n_steps=n_steps, policy=policy)
    assert len(calls) == 1
    direct = shipped(tr.env_cfg, tr.params, policy, n_steps, device="cpu")
    assert set(table) == set(direct) and len(table) == 37
    for k, v in direct.items():
        assert table[k].shape == (tr.cfg.n_districts,) + v.shape, k
        assert torch.equal(table[k][-1].nan_to_num(), v.nan_to_num()), k
