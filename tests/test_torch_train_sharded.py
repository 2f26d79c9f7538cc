"""``BatchedSAC`` and ``BatchedMARLISA`` over the port's district mesh
(``mesh=``) on the CPU: two gloo ranks of ``tests/_torch_mesh_worker.py``,
one spawned pair for every case.

- The kernel collect (K2's plain version here) at D=256 over 12 warmup
  steps: against the JAX package's sharded trainer
  (``BatchedSAC(mesh=district_mesh(2))``) from its initial state and with
  its exploration actions, within JAX's own 2e-5 on ``battery_soc`` and
  ``replay_rew`` (``tests/test_collect_fast.py``'s sharded test); against
  the port's unsharded trainer from the same seed, bit for bit: each
  rank's rows of the district state, the replay and the carried
  observations.
- With updates (batch 32, hidden 8x8): the ranks' networks and Adam
  states bit-identical, and within 1e-5 of scale of the unsharded
  trainer's (the policy's matrix products over a rank's districts may
  round otherwise than over all of them); the sharded ``evaluate``
  returns the global batch's table.
- The per-step collect on a thermal district: warmup rows bit-equal to
  the unsharded trainer's, replicas identical after updates.
- ``BatchedMARLISA``: the ridge accumulators within 1e-5 of the unsharded
  ones, the same accumulators and weights on both ranks.
- A checkpoint written by the two ranks restores into one process, which
  continues bit-equal to the two-rank run during warmup."""

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu_torch.synthetic import write_battery_pv_dataset, write_thermal_dataset
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig, train_state_from_numpy
from citylearn_tpu_torch.train_marlisa import BatchedMARLISA

from _torch_mesh_worker import WORLD, spawn_ranks

D, EPISODE = 256, 24
WARM = dict(n_districts=D, warmup_steps=10**9, batch_size=32, replay_capacity=D * 16,
            hidden=(8, 8), collect="kernel")
UPDATES = dict(WARM, warmup_steps=4)
THERMAL = dict(n_districts=4, warmup_steps=4, batch_size=16, replay_capacity=4 * 64,
               hidden=(8, 8))
MARLISA = dict(n_districts=8, warmup_steps=10**9, batch_size=16, replay_capacity=8 * 64,
               hidden=(8, 8))
MARLISA_KW = dict(regression_update_every=4)


def leaves(tree, prefix=""):
    """(name, leaf) pairs of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_identical(a, b):
    for (name, x), (_, y) in zip(leaves(a), leaves(b), strict=True):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y, name


def joined(ranks, field, dim=0):
    """A field of the ranks' states along the district axis."""
    get = lambda r: r[field] if field in r else getattr(r["env_state"], field)
    return torch.cat([get(r) for r in ranks], dim)


def assert_scaled_close(ours, ref, name, rtol=1e-5):
    scale = float(ref.abs().max()) or 1.0
    torch.testing.assert_close(ours, ref, rtol=rtol, atol=rtol * scale, msg=name)


def port(schema, config, marlisa=False, **kw):
    cls = BatchedMARLISA if marlisa else BatchedSAC
    return cls(schema, TrainConfig(**config), random_seed=0, episode_time_steps=EPISODE,
               device="cpu", **kw)


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    root = tmp_path_factory.mktemp("ds")
    return {"battery": write_battery_pv_dataset(f"{root}/battery", 5, 200, seed=0),
            "thermal": write_thermal_dataset(f"{root}/thermal", 4, 200, seed=5)}


@pytest.fixture(scope="module")
def jax_sharded(schemas):
    """JAX's sharded trainer over 12 warmup steps: its start and end states."""
    from citylearn_tpu.parallel import district_mesh
    from citylearn_tpu.train import BatchedSAC as JaxBatchedSAC
    from citylearn_tpu.train import TrainConfig as JaxTrainConfig

    tr = JaxBatchedSAC(schemas["battery"], JaxTrainConfig(**WARM), random_seed=0,
                       episode_time_steps=EPISODE, mesh=district_mesh(WORLD))
    assert tr.use_kernel_collect
    start = jax.tree_util.tree_map(np.asarray, tr.state)
    tr.train(12, chunk=12)
    return start, jax.tree_util.tree_map(np.asarray, tr.state)


@pytest.fixture(scope="module")
def ranks(schemas, jax_sharded, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ranks"))
    # JAX's start state as a port checkpoint of the global batch
    start, end = jax_sharded
    fed = port(schemas["battery"], WARM)
    fed.load_state(train_state_from_numpy(start, device="cpu"))
    fed.save_checkpoint(f"{root}/jax_start")
    bat = dict(schema=schemas["battery"], episode=EPISODE)
    job = {"mode": "train", "cases": [
        dict(bat, name="warmup", config=WARM, steps=[12], checkpoint=f"{root}/ckpt",
             then=[12]),
        dict(bat, name="jax", config=WARM, steps=[12], restore=f"{root}/jax_start",
             fed_actions=end.replay_act),
        dict(bat, name="updates", config=UPDATES, steps=[12, 12], evaluate=12),
        dict(name="thermal", schema=schemas["thermal"], episode=EPISODE, config=THERMAL,
             steps=[8]),
        dict(bat, name="marlisa", config=MARLISA, marlisa=True, trainer=MARLISA_KW,
             steps=[8])]}
    return spawn_ranks(job, root), root


def test_kernel_collect_equals_jax_sharded(ranks, jax_sharded):
    _, end = jax_sharded
    got = [r["jax"] for r in ranks[0]]
    assert all(r["use_kernel_collect"] for r in got)
    soc = joined(got, "battery_soc").numpy()
    rew = joined(got, "replay_rew", 1).numpy()
    np.testing.assert_array_equal(joined(got, "replay_act", 1).numpy(), end.replay_act)
    np.testing.assert_allclose(soc, np.asarray(end.env_state.battery_soc), rtol=0, atol=2e-5)
    np.testing.assert_allclose(rew, np.asarray(end.replay_rew), rtol=0, atol=2e-5)
    assert float(np.abs(end.replay_rew[:12]).max()) > 0


def test_kernel_collect_equals_unsharded(ranks, schemas):
    got = [r["warmup"] for r in ranks[0]]
    plain = port(schemas["battery"], WARM)
    history = plain.train(12, chunk=12)
    ts = plain.state
    for f in ("t", "data_offset", "battery_soc", "battery_efficiency",
              "battery_degraded_capacity"):
        assert torch.equal(joined(got, f), getattr(ts.env_state, f)), f
    assert torch.equal(joined(got, "cur_obs"), ts.cur_obs)
    for f in ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done"):
        assert torch.equal(joined(got, f, 1), getattr(ts, f)), f
    assert got[0]["replay_rew"].shape[1] == D // WORLD
    # the reward history is summed over the ranks: the same on each, the
    # unsharded sum's within rounding
    assert got[0]["history"] == got[1]["history"]
    np.testing.assert_allclose(got[0]["history"][0], history, rtol=1e-6)


def test_checkpoint_restores_into_one_process(ranks, schemas):
    """The two ranks' checkpoint holds the global batch: one process resumes
    from it as the two ranks went on, bit for bit."""
    got, root = [r["warmup"]["after"] for r in ranks[0]], ranks[1]
    one = port(schemas["battery"], WARM)
    one.restore_checkpoint(f"{root}/ckpt")
    assert one.state.step == 12 and one._phase == 12
    one.train(12, chunk=12)
    assert torch.equal(joined(got, "battery_soc"), one.state.env_state.battery_soc)
    assert torch.equal(joined(got, "replay_rew", 1), one.state.replay_rew)


def test_updates_keep_replicas_identical(ranks, schemas):
    got = [r["updates"] for r in ranks[0]]
    assert_identical(got[0]["nets"], got[1]["nets"])
    assert got[0]["history"] == got[1]["history"]
    plain = port(schemas["battery"], UPDATES)
    w0 = plain.state.nets.policy.mean_w.detach().clone()
    plain.train(12, chunk=12)
    plain.train(12, chunk=12)
    assert float((plain.state.nets.policy.mean_w.detach() - w0).abs().max()) > 0
    for (name, x), (_, y) in zip(leaves(got[0]["nets"]), leaves(plain.state.nets.state_dict()),
                                 strict=True):
        if torch.is_tensor(x) and x.is_floating_point():
            assert_scaled_close(x, y, name)
    assert_scaled_close(joined(got, "replay_rew", 1), plain.state.replay_rew, "replay_rew")
    # one batch all_reduce per update, one reward sum per collect chunk:
    # 12 steps, then 11 to the episode's end and 1
    n_updates = 24 - UPDATES["warmup_steps"]
    assert got[0]["collectives"] == n_updates + 3
    # evaluate: every rank returns the global batch's table
    table = got[0]["evaluate"]
    assert table["building|cost_total"].shape == (D, 5) and len(table) == 37
    for k, v in table.items():
        torch.testing.assert_close(v, got[1]["evaluate"][k], rtol=0, atol=0, equal_nan=True,
                                   msg=k)


def test_thermal_per_step_collect(ranks, schemas):
    got = [r["thermal"] for r in ranks[0]]
    assert not got[0]["use_kernel_collect"]
    plain = port(schemas["thermal"], THERMAL)
    plain.train(8, chunk=8)
    ts = plain.state
    warm = slice(0, THERMAL["warmup_steps"])
    for f in ("replay_obs", "replay_act", "replay_rew", "replay_next"):
        assert torch.equal(joined(got, f, 1)[warm], getattr(ts, f)[warm]), f
    assert_identical(got[0]["nets"], got[1]["nets"])
    for f in ("replay_rew", "replay_obs"):
        assert_scaled_close(joined(got, f, 1), getattr(ts, f), f)


def test_marlisa_ridge(ranks, schemas):
    got = [r["marlisa"] for r in ranks[0]]
    plain = port(schemas["battery"], MARLISA, marlisa=True, **MARLISA_KW)
    plain.train(8, chunk=8)
    for f in ("reg_xtx", "reg_xty", "reg_w"):
        assert torch.equal(got[0][f], got[1][f]), f
    # the accumulators sum the districts in another order; the weights
    # solve a system whose collinear encoder columns only the ridge holds
    # apart, which magnifies that rounding, so they are held to the ranks'
    # agreement alone
    for f in ("reg_xtx", "reg_xty"):
        assert_scaled_close(got[0][f], getattr(plain.state, f), f)
    assert float(got[0]["reg_w"].abs().max()) > 0


def test_world_of_one_trains_as_without_a_mesh(schemas):
    """A mesh of one rank takes the mesh's update path (the owned rows, one
    flat batch) and gives the meshless trainer's networks and replay bit
    for bit."""
    from citylearn_tpu_torch.parallel import district_mesh

    kw = dict(UPDATES, n_districts=128)
    sharded = port(schemas["battery"], kw, mesh=district_mesh(device="cpu"))
    plain = port(schemas["battery"], kw)
    for tr in (sharded, plain):
        tr.train(12, chunk=12)
    assert_identical(sharded.state.nets.state_dict(), plain.state.nets.state_dict())
    for f in ("replay_obs", "replay_act", "replay_rew", "cur_obs"):
        assert torch.equal(getattr(sharded.state, f), getattr(plain.state, f)), f


def test_kernel_collect_rule_counts_the_ranks(schemas):
    """JAX's rule, n_districts a multiple of 128 x the shards, so that a
    configuration takes the same path in both packages."""
    from citylearn_tpu_torch.parallel import DistrictMesh

    two = DistrictMesh(0, 2, torch.device("cpu"), None)
    assert not port(schemas["battery"], dict(WARM, n_districts=128, collect="auto"),
                    mesh=two).use_kernel_collect
    assert port(schemas["battery"], dict(WARM, n_districts=256), mesh=two).use_kernel_collect
    with pytest.raises(ValueError, match="128 x the mesh's ranks"):
        port(schemas["battery"], dict(WARM, n_districts=128), mesh=two)
    with pytest.raises(ValueError, match="does not split evenly"):
        port(schemas["battery"], dict(WARM, n_districts=129, collect="auto"), mesh=two)
