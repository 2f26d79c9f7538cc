"""The port's batched SAC trainer (``citylearn_tpu_torch.train``) against
the JAX package's and against itself.

- Construction: observation and action widths, action scale, bias and
  mask, window offsets and routing equal JAX's.
- Warmup transitions: the JAX trainer's state carried across with
  ``train_state_from_numpy`` and its exploration actions and reset
  offsets fed in through the port's draws; the port's replay rows and
  battery state then equal JAX's within 1e-5 relative to their scale
  (XLA:CPU's fused multiply-adds in the battery event, and its sine and
  cosine in the encoder), across an episode reset with per-district
  windows, on both of the port's collect paths.
- The port's two paths draw the same numbers: actions bit-equal, state
  within 2e-5 (the kernel path runs the recurrence in another program).
- Evaluation of carried networks equals JAX's KPI table (1e-5 relative).
- Training on the kernel path updates the networks; save/load and full
  checkpoints round-trip."""

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu_torch import train
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.ops import collect as k2
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset
from citylearn_tpu_torch.train import (
    BatchedSAC,
    StepDraws,
    TrainConfig,
    train_state_from_numpy,
)

D, B, EPISODE = 128, 5, 48          # 47 steps per episode
BASE = dict(n_districts=D, hidden=(16, 16), batch_size=32, replay_capacity=D * 64)
RBC = np.where(np.arange(1, 25) < 9, 0.091, -0.08).astype(np.float32)


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 200, seed=0)


def port(dataset, collect="auto", episode=EPISODE, **kw):
    return BatchedSAC(dataset, TrainConfig(collect=collect, **dict(BASE, **kw)),
                      random_seed=0, episode_time_steps=episode, device="cpu")


def jax_trainer(dataset, collect="scan", episode=EPISODE, **kw):
    from citylearn_tpu.train import BatchedSAC as JaxBatchedSAC
    from citylearn_tpu.train import TrainConfig as JaxTrainConfig

    return JaxBatchedSAC(dataset, JaxTrainConfig(collect=collect, **dict(BASE, **kw)),
                         random_seed=0, episode_time_steps=episode)


def as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class FedDraws(StepDraws):
    """The JAX trainer's exploration actions and reset offsets."""

    def __init__(self, actions, reset_offsets):
        super().__init__(0, torch.device("cpu"))
        self.actions, self.reset_offsets = actions, reset_offsets

    def explore(self, t, low, high, n):
        return torch.tensor(self.actions[t])

    def offsets(self, t, purpose, n, max_offset):
        assert purpose == StepDraws.RESET
        return torch.tensor(self.reset_offsets)


def assert_states_close(ours, ref, atol=None, rtol=1e-5):
    """Replay, battery state and carried observations of two trainers:
    within ``atol`` absolute if given, else ``rtol`` relative to scale."""
    check = ((lambda a, b, n: np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                                         atol=atol, err_msg=n))
             if atol is not None else (lambda a, b, n: assert_close(a, b, n, rtol)))
    as_t = lambda x: x if torch.is_tensor(x) else torch.tensor(np.asarray(x))
    assert int(ours.step) == int(ref.step)
    assert int(ours.replay_pos) == int(ref.replay_pos)
    assert bool(ours.replay_full) == bool(ref.replay_full)
    for f in ("t", "data_offset"):
        np.testing.assert_array_equal(getattr(ours.env_state, f).numpy(),
                                      np.asarray(getattr(ref.env_state, f)), err_msg=f)
    for f in ("battery_soc", "battery_efficiency", "battery_degraded_capacity"):
        check(getattr(ours.env_state, f), as_t(getattr(ref.env_state, f)), f)
    for f in ("cur_obs", "replay_obs", "replay_rew", "replay_next", "replay_done"):
        check(getattr(ours, f), as_t(getattr(ref, f)), f)


def test_construction_matches_jax(dataset):
    ours, ref = port(dataset), jax_trainer(dataset, collect="auto")
    assert (ours.obs_dim, ours.act_dim, ours.max_offset) == (ref.obs_dim, ref.act_dim,
                                                            ref.max_offset)
    assert (ours.obs_dim, ours.act_dim) == (27, 1)
    for f in ("act_low", "act_high", "act_mask", "action_scale", "action_bias", "w_bld"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("src", "kind", "p1", "p2"):
        np.testing.assert_array_equal(getattr(ours.enc_stack, f).numpy(),
                                      np.asarray(getattr(ref.enc_stack, f)), err_msg=f)
    np.testing.assert_allclose(ours._enc_table.numpy(), np.asarray(ref._enc_table),
                               rtol=0, atol=1e-6)
    assert ours.use_kernel_collect and ref.use_kernel_collect
    assert ours.state.replay_obs.shape == ref.state.replay_obs.shape
    assert ours.state.replay_act.shape == ref.state.replay_act.shape


@pytest.fixture(scope="module")
def jax_warmup(dataset):
    """60 warmup steps of the JAX trainer (one episode reset, at step 46)."""
    tr = jax_trainer(dataset, warmup_steps=10**9)
    start = as_numpy(tr.state)
    tr.train(60, chunk=60)
    return start, as_numpy(tr.state), tr.max_offset


@pytest.mark.parametrize("collect", ["scan", "kernel"])
def test_warmup_transitions_match_jax(dataset, jax_warmup, collect, monkeypatch):
    start, end, max_offset = jax_warmup
    tr = port(dataset, collect=collect, warmup_steps=10**9)
    assert tr.use_kernel_collect == (collect == "kernel") and max_offset > 0
    tr.load_state(train_state_from_numpy(start, device="cpu"))
    tr.draws = FedDraws(end.replay_act, end.env_state.data_offset)
    chunks = []
    monkeypatch.setattr(train, "battery_collect_chunk",
                        lambda *a, **kw: chunks.append(a[1].shape[0]) or
                        k2.battery_collect_chunk(*a, **kw))
    tr.train(60, chunk=30)
    # chunks end at the episode reset: 30, 17 and 13 steps
    assert chunks == ([30, 17, 13] if collect == "kernel" else [])
    np.testing.assert_array_equal(tr.state.replay_act.numpy(), end.replay_act)
    assert_states_close(tr.state, end)
    assert len(np.unique(end.env_state.data_offset)) > 1


def test_port_paths_draw_alike(dataset):
    """Warmup on both paths from the same seed, 100 steps across two
    episode resets: the same exploration actions and reset windows."""
    scan = port(dataset, collect="scan", warmup_steps=10**9)
    kern = port(dataset, collect="kernel", warmup_steps=10**9)
    scan.train(100, chunk=50)
    kern.train(100, chunk=50)
    assert torch.equal(scan.state.replay_act, kern.state.replay_act)
    assert_states_close(kern.state, scan.state, atol=2e-5)
    assert len(torch.unique(kern.state.env_state.data_offset)) > 1


def test_port_paths_agree_past_warmup(dataset):
    """The policy acts from step 4; updates are held off (the batch is
    larger than the buffer), so both paths act with the same policy: the
    chunked sweep and the per-step forward differ only in the order of
    the matrix products' sums."""
    kw = dict(warmup_steps=4, batch_size=D * 64 + 1)
    scan, kern = port(dataset, collect="scan", **kw), port(dataset, collect="kernel", **kw)
    scan.train(24, chunk=12)
    kern.train(24, chunk=12)
    assert_states_close(kern.state, scan.state, atol=5e-4)
    np.testing.assert_allclose(kern.state.replay_act.numpy(), scan.state.replay_act.numpy(),
                               rtol=0, atol=5e-4)
    assert torch.equal(scan.state.nets.policy.mean_w, kern.state.nets.policy.mean_w)


def test_evaluate_matches_jax(dataset):
    """KPI tables of carried networks, on districts whose window cannot
    move (the episode spans the data), so both draw the same offsets."""
    kw = dict(n_districts=4, warmup_steps=10**9)
    ref = jax_trainer(dataset, episode=200, **kw)
    nets = ref.state.nets
    # a policy that acts: scale the mean head up
    policy = dict(nets.policy, mean={"w": nets.policy["mean"]["w"] * 300.0,
                                     "b": nets.policy["mean"]["b"]})
    ref.state = ref.state._replace(nets=nets._replace(policy=policy))
    ours = port(dataset, episode=200, **kw)
    assert ours.max_offset == 0
    ours.load_state(train_state_from_numpy(as_numpy(ref.state), device="cpu"))
    table, jtable = ours.evaluate(n_steps=24), ref.evaluate(n_steps=24)
    assert set(table) == set(jtable) and len(table) == 37
    for k in sorted(table):
        np.testing.assert_allclose(table[k].numpy(), np.asarray(jtable[k]), rtol=1e-5,
                                   atol=1e-6, equal_nan=True, err_msg=k)
    assert not np.allclose(table["district|cost_total"].numpy(), 1.0)


def test_kernel_path_trains_and_evaluates(dataset):
    tr = port(dataset, collect="kernel", warmup_steps=4)
    w0 = tr.state.nets.policy.mean_w.detach().clone()
    q0 = tr.state.nets.q1_target.w[0].detach().clone()
    hist = tr.train(24, chunk=12)
    assert len(hist) == 2 and all(np.isfinite(h) for h in hist)
    assert (tr.state.nets.policy.mean_w - w0).abs().max() > 0, "the policy never updated"
    assert (tr.state.nets.q1_target.w[0] - q0).abs().max() > 0, "the targets never moved"
    assert float(tr.state.nets.policy_opt.state[tr.state.nets.policy.mean_w]["step"]) == 20
    table = tr.evaluate(n_steps=24)
    assert len(table) == 37 and table["building|cost_total"].shape == (D, B)
    assert torch.isfinite(table["district|cost_total"]).all()
    # a scripted baseline goes through the whole-episode kernel path
    rbc = ScriptedPolicy({"electrical_storage": RBC}, hour_tables=True)
    scripted = tr.evaluate(n_steps=24, policy=rbc)
    direct = evaluate_scripted(tr.env_cfg, tr.params, rbc, 24, device="cpu")
    for k, v in direct.items():
        assert torch.equal(scripted[k][0].nan_to_num(), v.nan_to_num()), k


def test_routing(dataset):
    assert not port(dataset, n_districts=4).use_kernel_collect
    assert not port(dataset, collect="scan").use_kernel_collect
    with pytest.raises(ValueError, match="collect='kernel'"):
        port(dataset, collect="kernel", n_districts=4)


def test_save_load_round_trip(dataset, tmp_path):
    tr = port(dataset, collect="kernel", warmup_steps=4)
    tr.train(12, chunk=12)
    path = str(tmp_path / "nets.pt")
    tr.save(path)
    saved = {k: v.clone() for k, v in tr.state.nets.policy.state_dict().items()}
    tr.train(12, chunk=12)
    assert not torch.equal(saved["mean_w"], tr.state.nets.policy.mean_w)
    tr.load(path)
    for k, v in tr.state.nets.policy.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_checkpoint_resume(dataset, tmp_path):
    """A full checkpoint restores the episode phase, so chunk alignment
    and the draws continue bit-exactly."""
    tr = port(dataset, collect="kernel", warmup_steps=20)
    tr.train(30, chunk=30)
    tr.save_checkpoint(str(tmp_path / "ckpt"))
    tr.train(20, chunk=20)
    soc1 = tr.state.env_state.battery_soc.clone()
    w1 = tr.state.nets.policy.mean_w.detach().clone()

    tr.restore_checkpoint(str(tmp_path / "ckpt"))
    assert tr._phase == 30 and tr.state.step == 30
    tr.train(20, chunk=20)
    assert torch.equal(soc1, tr.state.env_state.battery_soc)
    assert torch.equal(w1, tr.state.nets.policy.mean_w)
