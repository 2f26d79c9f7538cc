"""One rank of the port's district mesh on the CPU, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_train_sharded.py``:
a gloo process group of ``world`` processes, each a
:class:`citylearn_tpu_torch.parallel.DistrictMesh` on the CPU. Imports the
port only (no JAX), as a rank on a card would.

    WORLD_SIZE=<world> RANK=<rank> MASTER_ADDR=localhost MASTER_PORT=<port> \
        python tests/_torch_mesh_worker.py <job.pt>

as :func:`spawn_ranks` starts it, once for each rank, with the variables
that ``torchrun`` sets: each rank joins the group through
``initialize_distributed``'s ``env://`` default.

``job.pt`` holds ``{"mode": "evaluate" | "train", "out": dir, ...}``; the
rank writes what it computed to ``<out>/rank<rank>.pt``. Modes:

- ``evaluate``: for each family of ``job["families"]`` (name, schema,
  plans, steps, global districts), ``evaluate_scripted(mesh=)`` with its
  recorded stream, the family's ``run_*_episode(mesh=)`` state outputs,
  and the mesh's collective count across both; then each collective
  wrapper once, and a mesh over the first rank alone;
- ``train``: the cases of ``job["cases"]``, each a trainer (``BatchedSAC``
  or ``BatchedMARLISA``) built with ``mesh=``, optionally restored from a
  checkpoint and fed another trainer's exploration actions, driven by its
  steps; then its state, and optionally a checkpoint written and the
  steps after it, and its ``evaluate`` table.
"""

import copy
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from citylearn_tpu_torch.compiler.schema import compile_schema  # noqa: E402
from citylearn_tpu_torch.core import rollout_fast  # noqa: E402
from citylearn_tpu_torch.core.evaluate_fast import (  # noqa: E402
    ScriptedPolicy,
    evaluate_scripted,
    kernel_family,
)
from citylearn_tpu_torch.core.params import pack  # noqa: E402
from citylearn_tpu_torch.parallel import (  # noqa: E402
    all_reduce,
    broadcast,
    district_mesh,
    free_port,
    gather_districts,
    initialize_distributed,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RUN = {"battery": rollout_fast.run_battery_episode, "thermal": rollout_fast.run_thermal_episode,
       "ev": rollout_fast.run_ev_episode, "lstm": rollout_fast.run_lstm_episode,
       "neighborhood": rollout_fast.run_neighborhood_episode}


def run_episode(cfg, params, plans, n_districts, n_steps, **kw):
    """The family's ``run_*_episode`` under ``plans`` (the battery family
    takes its one plan)."""
    family = kernel_family(cfg)
    action = plans["electrical_storage"] if family == "battery" else plans
    return RUN[family](cfg, params, n_districts, action, n_steps=n_steps, **kw)


def evaluate(job, mesh):
    out = {}
    for fam in job["families"]:
        cfg, params, _ = pack(compile_schema(fam["schema"]), device="cpu")
        policy = ScriptedPolicy(fam["plans"])
        before = mesh.collectives
        table, rec = evaluate_scripted(cfg, params, policy, fam["steps"],
                                       n_districts=fam["districts"], return_series=True,
                                       mesh=mesh)
        state = run_episode(cfg, params, fam["plans"], fam["districts"], fam["steps"],
                            mesh=mesh)
        out[fam["name"]] = dict(table=table, rec=rec, state=state,
                                collectives=mesh.collectives - before)
    before = mesh.collectives
    r = mesh.rank
    sub = district_mesh(1, device="cpu")
    out["collectives"] = dict(
        gathered=gather_districts(mesh, (torch.arange(2.0) + 2 * r).view(2, 1) * 10),
        gathered_dim1=gather_districts(mesh, (torch.arange(2.0) + 2 * r).view(1, 2), dim=1),
        reduced=all_reduce(mesh, torch.tensor(float(r + 1))),
        broadcast=broadcast(mesh, torch.tensor(7.0 if r == 0 else -1.0)),
        count=mesh.collectives - before,
        sub=None if sub is None else (sub.rank, sub.world_size))
    return out


class FedDraws:
    """Exploration actions by step from another trainer (the JAX
    package's), at the global batch; the other draws the trainer's own."""

    def __init__(self, draws, actions):
        self.draws, self.actions = draws, actions

    def explore(self, t, low, high, n):
        return torch.as_tensor(self.actions[t])

    def __getattr__(self, name):
        return getattr(self.draws, name)


def train(job, mesh):
    from citylearn_tpu_torch.train import BatchedSAC, TrainConfig
    from citylearn_tpu_torch.train_marlisa import BatchedMARLISA

    out = {}
    for case in job["cases"]:
        cls = BatchedMARLISA if case.get("marlisa") else BatchedSAC
        tr = cls(case["schema"], TrainConfig(**case["config"]), random_seed=0,
                 episode_time_steps=case["episode"], mesh=mesh, **case.get("trainer", {}))
        if case.get("restore"):
            tr.restore_checkpoint(case["restore"])
        if case.get("fed_actions") is not None:
            tr.draws = FedDraws(tr.draws, case["fed_actions"])
        before = mesh.collectives
        history = [tr.train(n, chunk=n) for n in case["steps"]]
        ts = tr.base_state
        result = dict(history=history, collectives=mesh.collectives - before,
                      use_kernel_collect=tr.use_kernel_collect,
                      env_state=ts.env_state, nets=ts.nets.state_dict(),
                      **{k: getattr(ts, k) for k in ts.BUFFERS})
        if case.get("marlisa"):
            result.update(reg_xtx=tr.state.reg_xtx, reg_xty=tr.state.reg_xty,
                          reg_w=tr.state.reg_w)
        result = copy.deepcopy(result)          # training goes on in place
        if case.get("checkpoint"):
            tr.save_checkpoint(case["checkpoint"])
            result["after"] = dict(history=[tr.train(n, chunk=n) for n in case["then"]],
                                   env_state=tr.base_state.env_state,
                                   replay_rew=tr.base_state.replay_rew)
        if case.get("evaluate"):
            result["evaluate"] = tr.evaluate(n_steps=case["evaluate"])
        out[case["name"]] = result
    return out


def spawn_ranks(job, tmp_path, timeout=300, world=WORLD):
    """Run ``job`` on ``world`` gloo ranks of ``tests/_torch_mesh_worker.py``;
    returns each rank's result, in rank order."""
    job = dict(job, out=str(tmp_path))
    job_path = os.path.join(tmp_path, "job.pt")
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen([sys.executable, __file__, job_path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=REPO)
             for r in range(world)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    return [torch.load(os.path.join(tmp_path, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.set_num_threads(1)
    job = torch.load(sys.argv[1], weights_only=False)
    # gloo named: on a machine with a card the default would be nccl
    initialize_distributed(backend="gloo")
    mesh = district_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size) == (rank, world)
    result = {"evaluate": evaluate, "train": train}[job["mode"]](job, mesh)
    torch.save(result, os.path.join(job["out"], f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
