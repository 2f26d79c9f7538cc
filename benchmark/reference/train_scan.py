"""The batched SAC trainer's per-step collect on an LSTM-dynamics district,
worked out again in plain PyTorch: ``BatchedSAC.train(K, chunk=K)`` on
``collect="scan"`` (``citylearn_tpu_torch/train.py::_scan_step``), one
district hour at a time (:mod:`benchmark.reference.lstm_district`).

Each step, in the order the trainer runs it: the step's action (uniform
exploration for the first ``warmup_steps`` steps, then the current
policy's sample), one hour of every district, the scaled reward, the next
observation row, the episode's end and its reset with freshly drawn
windows (every district ends together: the episode is ``episode_time_steps
- 1`` hours), the transition written to the replay ring, and then one SAC
update of every agent once the replay holds a batch and exploration is
over. So the policy changes after every step, where the chunked collect
acts a whole chunk with the chunk's first policy. The draws are
:class:`benchmark.reference.train.Draws`' formula, the update
:class:`benchmark.reference.train.ReferenceTrainer`'s.

With ``actions`` given (one (D, B, M) tensor a step) the trainer is
forced: it steps the districts and fills its replay with those actions in
place of its own policy's. Under a policy that changes every step, two
float32 trainers drift apart (Adam turns a gradient element's rounding
near zero into a whole step of ``lr``, and the next actions and their
rewards follow the changed policy), so the benchmark compares the
program's actions with what the program's own policy of that step gives
(:func:`policy_actions`), and the physics, the LSTM and the learner on the
program's actions.

:meth:`ReferenceScanTrainer.resumed` starts from a state that the program
recorded (networks, targets, Adam, replay, episode and district state), so
that one call of the program's can be followed from where it began.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import torch

from benchmark.reference import lstm_district, sac
from benchmark.reference.train import ACT, EXPLORE, INIT, RESET, Draws, Job, ReferenceTrainer

FAULTS = ("frozen_state", "half_batch", "altered_action", "lstm_uncarried")


@dataclass
class Record:
    """What the comparison reads of a run, the program's or the
    reference's, in the reference's layout."""
    losses: List[List[Dict[str, torch.Tensor]]] = field(default_factory=list)  # per call, per update
    first_grads: Dict[str, Dict[str, torch.Tensor]] = None
    after: Dict[str, Dict[str, torch.Tensor]] = None       # the networks after the recorded calls
    rewards: torch.Tensor = None          # (K, D, B) scaled rewards of the first call
    actions: torch.Tensor = None          # (steps, D, B, M) every recorded step's actions
    policies: List[Dict[str, torch.Tensor]] = None  # the first call's policy before each step
    temperature: torch.Tensor = None      # (steps, D, B) indoor temperature of every recorded step
    state: Dict[str, torch.Tensor] = None  # after the first call (see :func:`state_of`)
    resets: List[Dict[str, torch.Tensor]] = field(default_factory=list)  # each reset's new state


def state_of(s: lstm_district.State) -> Dict[str, torch.Tensor]:
    """The district state as the comparison reads it."""
    return {"offset": s.offset.clone(), "t": torch.tensor(s.t), "soc": s.soc.clone(),
            "eff": s.eff.clone(), "deg": s.deg.clone(), "dhw_soc": s.dhw_soc.clone(),
            "h": s.h.clone(), "c": s.c.clone(), "window": s.window.clone()}


class ReferenceScanTrainer(ReferenceTrainer):
    """Follows ``train(chunk, chunk=chunk)`` calls from a fresh trainer
    whose networks hold ``nets``. ``precision='tf32'`` is the control;
    ``fault`` one of :data:`FAULTS`, planted here in the program's place;
    ``actions`` forces the steps' actions (one (D, B, M) tensor a step)."""

    def __init__(self, schema_path: str, job: Job, seed: int, nets, device, precision="fp32",
                 fault: str = None, actions: Sequence[torch.Tensor] = None):
        self.job, self.device, self.fault = job, device, fault
        self.district = d = lstm_district.load(schema_path, device)
        self.B = len(d.buildings)
        self.obs = lstm_district.observation_table(d)                     # (T, B*K)
        self.K = self.obs.shape[1] // self.B
        self.M = len(d.action_names)
        self.low, self.high = lstm_district.action_bounds(d)
        self.scale, self.bias = (self.high - self.low) / 2.0, (self.high + self.low) / 2.0
        self.S_ep = job.episode_time_steps - 1
        self.max_offset = d.n_rows - job.episode_time_steps
        self.draws = Draws(seed, device)
        self.mm = sac.MATMULS[precision]
        self.agents = sac.Agents(nets, job.lr, self.mm)
        D, B, S = job.n_districts, self.B, job.replay_slots
        self.S = S
        z = lambda *s: torch.zeros(s, device=device)
        self.r_obs, self.r_next = z(S, D, B * self.K), z(S, D, B * self.K)
        self.r_act, self.r_rew, self.r_done = z(S, D, B, self.M), z(S, D, B), z(S, D)
        self.pos, self.full, self.step, self.phase = 0, False, 0, 0
        self.state = lstm_district.initial(d, self.draws.offsets(0, INIT, D, self.max_offset))
        self.record = Record()
        self.forced = list(actions) if actions is not None else None
        self.steps: List[Dict[str, torch.Tensor]] = []   # every step's rows, rewards, ...

    @classmethod
    def resumed(cls, schema_path: str, job: Job, seed: int, start: dict, device,
                actions: Sequence[torch.Tensor] = None) -> "ReferenceScanTrainer":
        """A trainer at a recorded start: ``start`` holds ``nets`` and
        ``targets`` (leaves by name), ``adam`` ({net: {leaf: (step,
        exp_avg, exp_avg_sq)}}), ``replay`` (obs, act, rew, next, done),
        ``pos``, ``full``, ``step``, ``phase`` and ``state`` (a
        :class:`lstm_district.State`)."""
        tr = cls(schema_path, job, seed, start["nets"], device, actions=actions)
        a = tr.agents
        for name in ("q1", "q2"):
            setattr(a, f"{name}_target", {k: v.clone() for k, v in start["targets"][name].items()})
        for name, leaves in start["adam"].items():
            opt, params = a.opt[name], getattr(a, name)
            for leaf, (n, m1, m2) in leaves.items():
                opt.state[params[leaf]] = {"step": torch.tensor(float(n)),
                                           "exp_avg": m1.clone(), "exp_avg_sq": m2.clone()}
        tr.r_obs, tr.r_act, tr.r_rew, tr.r_next, tr.r_done = (x.clone() for x in start["replay"])
        tr.pos, tr.full, tr.step, tr.phase = start["pos"], start["full"], start["step"], start["phase"]
        tr.state = start["state"]
        return tr

    def train_call(self):
        """One ``train(chunk, chunk=chunk)``: ``chunk`` steps, each
        followed by its update."""
        self.record.losses.append([])
        first = self.step == 0
        for _ in range(self.job.chunk):
            self._step_once(record_policy=first)
        rec = self.record
        rec.temperature, rec.actions = self.stacked("temperature"), self.stacked("action")
        if first:
            rec.rewards = self.stacked("reward")
            rec.state = state_of(self.state)

    def stacked(self, key: str, last: int = None) -> torch.Tensor:
        """One of every step's records, stacked over the steps (the last
        ``last`` steps only, if given)."""
        return torch.stack([s[key] for s in self.steps[-last if last else 0:]])

    def _own_action(self, t: int, obs: torch.Tensor) -> torch.Tensor:
        a = policy_action(self, t, obs, self.agents.policy, self.mm)
        if self.fault == "altered_action":
            # district 0, building 0: the battery's action reversed where it is made
            a = a.clone()
            i = self.district.action_names.index("electrical_storage")
            a[0, 0, i] = -a[0, 0, i]
        return a

    def _step_once(self, record_policy: bool = False):
        job, d, s = self.job, self.district, self.state
        t = self.step
        rows = s.offset + s.t
        obs = self.obs[rows]
        if self.forced is not None:
            a = self.forced[len(self.steps)]
        else:
            if record_policy:
                self.record.policies = (self.record.policies or []) + [
                    {k: v.detach().clone() for k, v in self.agents.policy.items()}]
            a = self._own_action(t, obs)
        new, out = lstm_district.step(d, s, a, self.mm, carry=self.fault != "lstm_uncarried")
        reward = out.reward * job.reward_scale
        next_obs = self.obs[rows + 1]
        terminated = self.phase + 1 == self.S_ep
        if terminated:
            new = lstm_district.initial(d, self.draws.offsets(t, RESET, job.n_districts,
                                                              self.max_offset))
            self.record.resets.append(state_of(new))
        slot = self.pos
        self.r_obs[slot], self.r_act[slot], self.r_rew[slot] = obs, a, reward
        self.r_next[slot], self.r_done[slot] = next_obs, float(terminated)
        self.pos = (slot + 1) % self.S
        self.full = self.full or slot + 1 >= self.S
        avail = self.S if self.full else self.pos
        if avail * job.n_districts >= job.batch_size and t >= job.warmup_steps:
            self.record.losses[-1].append(self._update(t, avail))
        self.state, self.step = new, t + 1
        self.phase = 0 if terminated else self.phase + 1
        self.steps.append({"t": torch.tensor(t), "rows": rows, "reward": reward, "action": a,
                           "temperature": out.temperature, "heating": out.heating,
                           "done": torch.tensor(float(terminated))})


def policy_action(tr: ReferenceScanTrainer, t: int, obs: torch.Tensor, policy, mm=torch.matmul
                  ) -> torch.Tensor:
    """Step ``t``'s action (D, B, M) on observation rows ``obs`` (D, B*K):
    uniform exploration during the warm-up, else a sample of ``policy``
    with the step's drawn noise."""
    D, B, K, M = tr.job.n_districts, tr.B, tr.K, tr.M
    if t < tr.job.warmup_steps:
        u = torch.rand((D, B, M), generator=tr.draws.generator(t, EXPLORE), device=tr.device)
        return tr.low + u * (tr.high - tr.low)
    noise = torch.randn((D, B, M), generator=tr.draws.generator(t, ACT), device=tr.device)
    return sac.act(policy, obs.view(D, B, K).transpose(0, 1), noise.transpose(0, 1), tr.scale,
                   tr.bias, mm).transpose(0, 1)


def policy_actions(tr: ReferenceScanTrainer, policies: Sequence[Dict[str, torch.Tensor]],
                   steps: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The actions (steps, D, B, M) that the given policies, one a step,
    take at the given steps (each's ``t`` and data ``rows``)."""
    return torch.stack([policy_action(tr, int(s["t"]), tr.obs[s["rows"]], p)
                        for p, s in zip(policies, steps)])
