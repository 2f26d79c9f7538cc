"""The port's district mesh (``citylearn_tpu_torch.parallel``) on the CPU:
two gloo processes, each a rank of ``tests/_torch_mesh_worker.py``, run the
sharded whole-episode evaluation on every family, as the JAX package's
``district_mesh(2)`` over conftest's virtual devices runs it.

- ``district_slice`` and its divisibility error (JAX asserts what the port
  raises); ``initialize_distributed`` is a no-op at a world of one; a mesh
  on an absent card, or a launch on another device than the mesh's, raises.
- ``evaluate_scripted(mesh=)`` at 168 steps (the EULP-shaped district at
  48) on battery+PV, thermal, EV, LSTM and neighborhood districts, two
  districts per rank:
  - against the port's single process over the same four districts, bit
    for bit: each rank's table and record (the LSTM family's
    temperature-driven KPIs within 1e-6 relative, as the plain LSTM's
    matrix products at another batch may round differently), and each
    rank's state outputs against its rows of the single launch;
  - with the mesh's collective counter at 0 across the evaluation;
  - against JAX's ``evaluate_scripted(mesh=district_mesh(2),
    interpret=True)`` (its default batch, its tile x 2; the table is
    district 0's either way) within 1e-5 of max(|value|, 1), the comfort
    KPIs of the dynamics districts within 2 steps in S (a temperature
    within the LSTM's error of a threshold lands on its other side), as
    ``tests/test_torch_neighborhood_eval.py`` holds the unsharded tables.
- The collectives themselves on gloo: ``gather_districts``,
  ``all_reduce`` and ``broadcast`` give the expected values and count one
  call each; a mesh over the first rank alone leaves the other out.

One spawned pair runs every family, to pay the start-up once."""

import numpy as np
import pytest
import torch

from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.evaluate_fast import ScriptedPolicy, evaluate_scripted
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.parallel import (
    DistrictMesh,
    district_mesh,
    district_slice,
    initialize_distributed,
    shard_district_batch,
)
from citylearn_tpu_torch.synthetic import (
    write_battery_pv_dataset,
    write_ev_dataset,
    write_lstm_dataset,
    write_neighborhood_dataset,
    write_thermal_dataset,
)

import _torch_mesh_worker as worker

WORLD, PER_RANK = worker.WORLD, 2
D = WORLD * PER_RANK
HOURS = np.arange(1, 25)
BAT = np.where(HOURS < 9, 0.091, -0.08).astype(np.float32)
PLANS = {
    "battery": {"electrical_storage": BAT},
    "thermal": {"cooling_storage": np.where(HOURS < 9, 0.2, -0.15).astype(np.float32),
                "dhw_storage": np.where(HOURS < 6, 0.1, -0.1).astype(np.float32),
                "electrical_storage": BAT},
    "ev": {"electrical_storage": BAT,
           "electric_vehicle_storage": np.where(HOURS < 7, 0.8, -0.3).astype(np.float32),
           "washing_machine": np.where(HOURS == 10, 1.0, 0.0).astype(np.float32)},
    "lstm": {"cooling_device": np.where(HOURS < 12, 0.8, 0.4).astype(np.float32),
             "cooling_storage": np.where(HOURS < 7, 0.05, -0.03).astype(np.float32),
             "dhw_storage": np.full(24, 0.05, np.float32), "electrical_storage": BAT},
    "neighborhood": {"cooling_or_heating_device": np.where(HOURS < 12, 0.6, -0.5)
                     .astype(np.float32), "electrical_storage": BAT},
}
STEPS = {"battery": 168, "thermal": 168, "ev": 168, "lstm": 168, "neighborhood": 48}
FAMILIES = tuple(PLANS)
COMFORT = ("discomfort", "one_minus_thermal_resilience")
# the LSTM family's KPIs that read its predicted temperature
LSTM_TEMPERATURE = ("discomfort", "one_minus_thermal_resilience", "comfort")


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    return {"battery": write_battery_pv_dataset(f"{root}/battery", 5, 200, seed=0),
            "thermal": write_thermal_dataset(f"{root}/thermal", 4, 200, seed=5),
            "ev": write_ev_dataset(f"{root}/ev", 4, 3, 4, 1, 200, seed=4),
            "lstm": write_lstm_dataset(f"{root}/lstm", n_rows=209, seed=9, lookback=4),
            "neighborhood": write_neighborhood_dataset(f"{root}/nb", 6, 200, seed=6)}


@pytest.fixture(scope="module")
def sharded(schemas, tmp_path_factory):
    job = {"mode": "evaluate", "families": [
        dict(name=f, schema=schemas[f], plans=PLANS[f], steps=STEPS[f], districts=D)
        for f in FAMILIES]}
    return worker.spawn_ranks(job, str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def single(schemas):
    """The port's single process over the same D districts."""
    out = {}
    for f in FAMILIES:
        cfg, params, _ = pack(compile_schema(schemas[f]), device="cpu")
        table, rec = evaluate_scripted(cfg, params, ScriptedPolicy(PLANS[f]), STEPS[f],
                                       n_districts=D, return_series=True, device="cpu")
        state = worker.run_episode(cfg, params, PLANS[f], D, STEPS[f], device="cpu")
        out[f] = dict(table=table, rec=rec, state=state)
    return out


def test_district_slice():
    meshes = [DistrictMesh(r, 4, torch.device("cpu"), None) for r in range(4)]
    assert [district_slice(m, 8) for m in meshes] == [slice(0, 2), slice(2, 4), slice(4, 6),
                                                      slice(6, 8)]
    assert district_slice(DistrictMesh(0, 1, torch.device("cpu"), None), 5) == slice(0, 5)
    # JAX asserts n_districts % (TILE_D * n_shards) == 0; the port's kernels
    # take any D, and the even split is the rule that is left
    with pytest.raises(ValueError, match="does not split evenly"):
        district_slice(meshes[1], 6)


def test_shard_district_batch(tmp_path):
    cfg, params, _ = pack(compile_schema(write_battery_pv_dataset(str(tmp_path), 3, 60)),
                          device="cpu")
    states = batched_initial_states(cfg, params, 6, device="cpu")
    states.battery_soc.copy_(torch.arange(18.0).view(6, 3))
    mine, p = shard_district_batch(DistrictMesh(1, 3, torch.device("cpu"), None), states,
                                   params)
    assert torch.equal(mine.battery_soc, states.battery_soc[2:4])
    assert mine.t.shape == (2,) and p.battery.capacity.shape == (3,)


def test_initialize_distributed_is_a_noop_at_world_one():
    initialize_distributed(world_size=1)
    assert not torch.distributed.is_initialized()
    mesh = district_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group, mesh.collectives) == (0, 1, None, 0)
    with pytest.raises(ValueError, match="process group"):
        district_mesh(2, device="cpu")


def test_no_fallback():
    """A mesh on an absent card raises; so does a launch on a device that
    is not the mesh's."""
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        district_mesh(device="cuda:0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        district_mesh()
    mesh = DistrictMesh(0, 1, torch.device("cpu"), None)
    with pytest.raises(ValueError, match="not the mesh's device"):
        rollout_fast.local_districts(mesh, 4, "cuda")


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_evaluation_equals_single_process(sharded, single, family):
    ref = single[family]
    for rank, result in enumerate(sharded):
        ours = result[family]
        assert ours["collectives"] == 0
        rows = slice(rank * PER_RANK, (rank + 1) * PER_RANK)
        assert len(ours["state"]) == len(ref["state"])
        for i, (a, b) in enumerate(zip(ours["state"], ref["state"])):
            assert a.shape[0] == PER_RANK
            assert torch.equal(a, b[rows]), (rank, i)
        assert set(ours["table"]) == set(ref["table"]) and len(ours["table"]) == 37
        if family == "lstm":
            # the plain LSTM's matrix products run over the rank's two
            # districts here and four there: temperature within 1e-6
            torch.testing.assert_close(ours["rec"], ref["rec"], rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(ours["rec"], ref["rec"])
        for k, v in ours["table"].items():
            if family == "lstm" and k.split("|")[1].startswith(LSTM_TEMPERATURE):
                torch.testing.assert_close(v, ref["table"][k], rtol=1e-6, atol=1e-6,
                                           equal_nan=True, msg=k)
            else:
                torch.testing.assert_close(v, ref["table"][k], rtol=0, atol=0, equal_nan=True,
                                           msg=f"rank {rank}, {k}")


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_evaluation_equals_jax(sharded, schemas, family):
    from citylearn_tpu.compiler.schema import compile_schema as jax_compile
    from citylearn_tpu.core.evaluate_fast import ScriptedPolicy as JaxPolicy
    from citylearn_tpu.core.evaluate_fast import evaluate_scripted as jax_evaluate
    from citylearn_tpu.core.params import pack as jax_pack
    from citylearn_tpu.parallel import district_mesh as jax_district_mesh

    jcfg, jparams, _ = jax_pack(jax_compile(schemas[family]))
    ref = jax_evaluate(jcfg, jparams, JaxPolicy(PLANS[family]), STEPS[family],
                       mesh=jax_district_mesh(WORLD), interpret=True)
    for result in sharded:
        ours = result[family]["table"]
        assert set(ours) == set(ref)
        for k in ours:
            a, b = ours[k].numpy(), np.asarray(ref[k])
            assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b)), k
            finite = ~np.isnan(b)
            err = float((np.abs(a - b)[finite] / np.maximum(np.abs(b[finite]), 1.0))
                        .max(initial=0))
            comfort = family in ("lstm", "neighborhood") and \
                k.split("|")[1].startswith(COMFORT)
            assert err <= 1e-5 + (2 / STEPS[family] if comfort else 0.0), (k, err)


def test_collectives_on_gloo(sharded):
    for rank, result in enumerate(sharded):
        got = result["collectives"]
        assert torch.equal(got["gathered"], torch.arange(2.0 * WORLD).view(WORLD * 2, 1) * 10)
        assert torch.equal(got["gathered_dim1"], torch.arange(2.0 * WORLD).view(1, -1))
        assert float(got["reduced"]) == sum(range(1, WORLD + 1))
        assert float(got["broadcast"]) == 7.0
        assert got["count"] == 4
        assert got["sub"] == ((0, 1) if rank == 0 else None)


def test_world_of_one_equals_no_mesh(schemas):
    """A mesh of one rank and no process group runs what the meshless call
    runs, bit for bit, and its default batch is one district."""
    cfg, params, _ = pack(compile_schema(schemas["battery"]), device="cpu")
    mesh = district_mesh(device="cpu")
    policy = ScriptedPolicy(PLANS["battery"])
    ours, rec = evaluate_scripted(cfg, params, policy, 48, return_series=True, mesh=mesh)
    ref, ref_rec = evaluate_scripted(cfg, params, policy, 48, return_series=True,
                                     device="cpu")
    assert torch.equal(rec, ref_rec)
    for k, v in ours.items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, equal_nan=True, msg=k)
    share = worker.run_episode(cfg, params, PLANS["battery"], 3, 48, mesh=mesh)
    whole = worker.run_episode(cfg, params, PLANS["battery"], 3, 48, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(share, whole, strict=True))
    assert mesh.collectives == 0
