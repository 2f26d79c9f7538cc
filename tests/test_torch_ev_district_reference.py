"""The port on the EV district (``challenge2022_phase_all_plus_evs``'s shape:
battery+PV buildings with EV chargers, electric vehicles and a washing
machine, the EV reward) against the benchmark's independent plain-PyTorch
reference (``benchmark/reference/ev_district.py`` and
``train_scan_evs.py``), with seeded weights, on the CPU at a small size: 4
buildings, 3 chargers, 4 EVs, 1 machine, D=8 districts, 200 rows, 48-step
episodes (the EVs dock from the episode's 16th hour), nets 32x32, batch 32.

- the benchmark's frozen EV writer writes the program's writer's bytes;
- ``district_step`` hour by hour under seeded actions, from several
  episode windows: the encoded observations, the rewards, the net
  consumption, the chargers' and the machine's consumption, the
  batteries', the EV batteries' and the machine's states;
- ``BatchedSAC.train`` on ``collect="scan"`` against the reference
  trainer: each update's losses, the actions and rewards written to the
  replay, the district state and the networks after, within one episode
  and across its end and reset;
- the cell's own comparison (``benchmark/entries/sac_train_evs.py``) at
  this size: every reading within its limit on a sound run, and outside
  at least one limit with each fault planted in the program or in the
  reference in its place, and with the TF32 control; the reward's
  close-SOC terms dropped in the program fail ``reward_gap`` (in the
  reference, whose readings see only the first call, which ends here
  before any EV docks, they fail ``loss_gap``).

Tolerances: both sides compute in float32 in other orders of the same
sums (the chargers' consumption summed by building, the batched
products), so the physics agrees to a few float32 rounding steps
(``rtol`` 1e-5, ``atol`` 1e-5 on values of order 1-50); the trainer's
networks, fed those values through up to 48 Adam updates, to 1e-4."""

import filecmp

import pytest
import torch

import citylearn_tpu_torch.train as train_mod
from benchmark import controls_evs, faults, faults_evs, faults_scan, harness
from benchmark.entries import sac_train_evs
from benchmark.frozen import synthetic_ev
from benchmark.reference import ev_district, sac as ref_sac
from benchmark.reference.train import Draws, Job
from benchmark.reference.train_scan_evs import FAULTS, ReferenceEVScanTrainer
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.synthetic import write_ev_dataset
from citylearn_tpu_torch.train import BatchedSAC, TrainConfig

D, ROWS, EPISODE = 8, 200, 48
SHAPE = dict(n_buildings=4, n_chargers=3, n_evs=4, n_washing_machines=1, n_rows=ROWS)
JOB = Job(n_districts=D, hidden=(32, 32), batch_size=32, replay_slots=64, warmup_steps=8,
          chunk=8, episode_time_steps=EPISODE)
TOL = dict(rtol=1e-5, atol=1e-5)
CELL = "challenge2022_phase_all_plus_evs.sac_train"
SEED = 2 ** 31 + 17
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The program's trainer at this size is a stream of small operations:
    a few seconds on one thread, minutes when every parallel test worker
    runs one thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def schema(tmp_path_factory):
    return write_ev_dataset(str(tmp_path_factory.mktemp("ev")), seed=5, **SHAPE)


def trainer(schema, seed):
    cfg = TrainConfig(n_districts=JOB.n_districts, hidden=JOB.hidden, batch_size=JOB.batch_size,
                      replay_capacity=JOB.n_districts * JOB.replay_slots,
                      warmup_steps=JOB.warmup_steps, collect="scan")
    return BatchedSAC(schema, cfg, seed=seed, device="cpu", episode_time_steps=EPISODE)


def seeded(tr, seed):
    """The trainer with seeded networks, and those networks."""
    g = torch.Generator(device=tr.device).manual_seed(seed)
    nets = ref_sac.init_params(tr.env_cfg.n_buildings, tr.obs_dim, tr.act_dim, JOB.hidden, g,
                               tr.device)
    with torch.no_grad():
        for name in ("q1", "q2", "policy"):
            for leaf, p in getattr(tr.state.nets, name).named_parameters():
                p.copy_(nets[name][leaf])
        for name in ("q1", "q2"):
            for leaf, p in getattr(tr.state.nets, f"{name}_target").named_parameters():
                p.copy_(nets[name][leaf])
    return nets


def close(ours, theirs, what, **tol):
    torch.testing.assert_close(ours, theirs.to(ours.dtype), msg=lambda m: f"{what}: {m}",
                               **(tol or TOL))


def test_the_frozen_writer_writes_the_programs_bytes(tmp_path):
    a, b = tmp_path / "frozen", tmp_path / "program"
    synthetic_ev.write_ev_dataset(str(a), seed=SEED, **SHAPE)
    write_ev_dataset(str(b), seed=SEED, **SHAPE)
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and len(names) > 10
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names and not mismatch and not errors


# --- the district hour by hour ------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_district_step_matches_the_reference(schema, seed):
    tr = trainer(schema, seed)
    d = ev_district.load(schema, "cpu", EPISODE)
    table = ev_district.observation_table(d)
    low, high, mask = ev_district.action_bounds(d)
    assert torch.equal(tr.act_low, low) and torch.equal(tr.act_high, high)
    assert torch.equal(tr.act_mask, mask)
    assert d.actions == [list(b.active_actions) for b in tr.spec.buildings]

    offsets = Draws(seed, "cpu").offsets(0, 5, D, ROWS - EPISODE)
    ours = tr._broadcast_initial(offsets.int())
    ref = ev_district.initial(d, offsets)
    g = torch.Generator().manual_seed(seed)
    moved = {"charged": 0, "machine": 0, "rewarded": 0}
    for t in range(EPISODE - 1):
        close(tr._encoded_obs(ours).reshape(D, -1), table[ref.offset + ref.t], f"obs {t}")
        a = (low + torch.rand((D,) + tuple(low.shape), generator=g) * (high - low)) * mask
        ours, out = district_step(tr.env_cfg, tr.params, ours, tr._actions_dict(a))
        ref, r = ev_district.step(d, ref, a)
        close(out.reward, r.reward, f"reward {t}")
        close(out.net_electricity_consumption, r.net, f"net {t}")
        close(out.chargers_consumption, r.chargers, f"chargers {t}")
        close(out.washing_machines_consumption, r.machines, f"machine {t}")
        close(ours.battery_soc, ref.soc, f"battery soc {t}")
        close(ours.battery_efficiency, ref.eff, f"battery efficiency {t}")
        close(ours.ev_soc, ref.ev_soc, f"ev soc {t}")
        close(ours.ev_efficiency, ref.ev_eff, f"ev efficiency {t}")
        close(ours.ev_degraded_capacity, ref.ev_deg, f"ev capacity {t}")
        assert torch.equal(ours.wm_initiated, ref.wm), f"machine started {t}"
        moved["charged"] += int((r.chargers != 0).sum())
        moved["machine"] += int((r.machines != 0).sum())
        moved["rewarded"] += int((r.reward != 0).sum())
    # the EVs charged and discharged, the machine ran, the EV reward paid
    assert all(n > 0 for n in moved.values()), moved


# --- the trainer ----------------------------------------------------------------------

@pytest.mark.parametrize("n_steps", [24, 56], ids=["one-episode", "across-the-reset"])
def test_training_matches_the_reference_trainer(schema, n_steps, monkeypatch):
    seed = 11
    tr = trainer(schema, seed)
    nets = seeded(tr, seed)
    shipped, losses = train_mod.sac_update, []
    monkeypatch.setattr(train_mod, "sac_update",
                        lambda *a, **kw: losses.append(shipped(*a, **kw)) or losses[-1])
    tr.train(n_steps, chunk=8)
    ref = ReferenceEVScanTrainer(schema, Job(**{**JOB.__dict__, "chunk": n_steps}), seed, nets,
                                 "cpu")
    ref.train_call()

    theirs = ref.record.losses[0]
    assert len(losses) == len(theirs) == n_steps - JOB.warmup_steps
    for i, (p, r) in enumerate(zip(losses, theirs)):
        for k in ("q1", "q2", "policy"):
            close(p[k], r[k], f"update {i} {k} loss", rtol=1e-4, atol=1e-4)
    ts = tr.state
    close(ts.replay_act[:n_steps], ref.stacked("action"), "actions", rtol=1e-4, atol=1e-5)
    close(ts.replay_rew[:n_steps], ref.stacked("reward"), "rewards", rtol=1e-4, atol=1e-4)
    close(ts.replay_done[:n_steps], ref.stacked("done")[:, None].expand(-1, D), "done")
    assert int(ts.replay_done.sum()) == D * (n_steps > EPISODE - 1)
    es = ts.env_state
    assert torch.equal(es.data_offset.long(), ref.state.offset)
    assert int(es.t[0]) == ref.state.t == (n_steps if n_steps < EPISODE - 1
                                           else n_steps - EPISODE + 1)
    close(es.battery_soc, ref.state.soc, "battery soc", rtol=1e-4, atol=1e-5)
    close(es.ev_soc, ref.state.ev_soc, "ev soc", rtol=1e-4, atol=1e-5)
    assert torch.equal(es.wm_initiated, ref.state.wm)
    for name in ("q1", "q2", "policy"):
        for leaf, p in getattr(ts.nets, name).named_parameters():
            close(p.detach(), ref.agents.trained()[name][leaf], f"{name}.{leaf}",
                  rtol=1e-4, atol=1e-5)


# --- the cell's comparison ------------------------------------------------------------

def small():
    """The cell at this file's size, with a 40-step episode so that its
    end comes within the first calls."""
    cell = harness.find_cell(harness.load_benchmark(), CELL)
    cell.traffic.update(n_districts=D, hidden=[32, 32], batch_size=32, replay_slots=16,
                        chunk=16, warmup_steps=8, episode_time_steps=40)
    cell.config.update(SHAPE)
    return cell


def correct(readings, cell, where_read=False) -> bool:
    limits = cell.traffic["limits"]
    if where_read:
        limits = {k: v for k, v in limits.items() if k in readings}
        assert len(limits) == len(cell.traffic["limits"]) - 1      # no reset_gap
    return all(c.ok for c in harness.checks(readings, limits))


@pytest.fixture
def restore(monkeypatch):
    """Undo whatever a planted fault patches in the program's modules."""
    for mod, attr in ((train_mod, "sac_update"), (train_mod, "district_step"),
                      (train_mod.BatchedSAC, "_broadcast_initial")):
        monkeypatch.setattr(mod, attr, getattr(mod, attr))


def test_the_cell_agrees_with_the_reference():
    cell = small()
    readings = sac_train_evs.run_cell(cell, SEED, 0.2, False, CPU)["readings"]
    assert set(readings) == set(cell.traffic["limits"]) and readings["reset_gap"] == 0
    assert correct(readings, cell), readings


@pytest.mark.parametrize("fault", [faults.frozen_update, faults.half_batch, faults.stale_reset,
                                   faults_scan.altered_action, faults_evs.scalar_efficiency,
                                   faults_evs.arrival_unforced, faults_evs.machine_unloaded,
                                   faults_evs.close_soc_dropped],
                         ids=lambda f: f.__name__)
def test_program_faults_fail(fault, restore):
    cell = small()
    readings = sac_train_evs.run_cell(cell, SEED, 0.0, False, CPU, fault=fault)["readings"]
    assert not correct(readings, cell), readings
    if fault is faults.stale_reset:
        assert readings["reset_gap"] > 0
    if fault is faults_evs.close_soc_dropped:       # the reward function's own fault
        assert readings["reward_gap"] > cell.traffic["limits"]["reward_gap"], readings


@pytest.mark.parametrize("what", ["tf32", *FAULTS])
def test_the_control_and_planted_reference_faults_fail(what):
    cell = small()
    readings = controls_evs.readings(cell, SEED, what, CPU)
    assert not correct(readings, cell, where_read=True), readings
