"""The batched SAC trainer's per-step collect on an EV district, worked out
again in plain PyTorch: ``BatchedSAC.train(K, chunk=K)`` on
``collect="scan"`` (``citylearn_tpu_torch/train.py::_scan_step``), one
district hour at a time (:mod:`benchmark.reference.ev_district`).

Each step runs in the order of :mod:`benchmark.reference.train_scan`: the
action (uniform exploration for ``warmup_steps`` steps, then the current
policy's sample with :class:`benchmark.reference.train.Draws`' noise), one
hour of every district, the scaled reward, the next observation row, the
episode's end and its reset with freshly drawn windows, the transition
written to the replay ring, then one SAC update of every agent
(:class:`benchmark.reference.train.ReferenceTrainer`'s draws). A
building's actions are the battery's, its chargers' and its machine's,
padded with zeros to the widest building: a padded slot acts 0 and adds
nothing to the policy's log-probability (:class:`MaskedAgents`), as the
program's ``act_mask`` does.

With ``actions`` given the trainer is forced onto them, for the reason
:mod:`benchmark.reference.train_scan` gives; :meth:`ReferenceEVScanTrainer.resumed`
starts from a state the program recorded.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import torch

from benchmark.reference import ev_district, sac
from benchmark.reference.train import INIT, RESET, Draws, Job
from benchmark.reference.train_scan import ReferenceScanTrainer, policy_action

FAULTS = ("frozen_state", "half_batch", "altered_action") + ev_district.FAULTS


def masked_sample(p, obs, noise, scale, bias, mask, mm):
    """:func:`benchmark.reference.sac.sample` with padded action slots
    (``mask`` 0, (A, M)) left out of the log-probability and acting 0."""
    n_hidden = sum(1 for k in p if k.startswith("trunk_w"))
    x = obs
    for i in range(n_hidden):
        x = torch.relu(sac._linear(x, p[f"trunk_w.{i}"], p[f"trunk_b.{i}"], mm))
    mean = sac._linear(x, p["mean_w"], p["mean_b"], mm)
    log_std = torch.clamp(sac._linear(x, p["log_std_w"], p["log_std_b"], mm),
                          sac.LOG_STD_MIN, sac.LOG_STD_MAX)
    std = torch.exp(log_std)
    u = mean + std * noise
    y = torch.tanh(u)
    scale, bias, mask = scale[:, None], bias[:, None], mask[:, None]
    log_prob = -0.5 * ((u - mean) / std) ** 2 - log_std - sac.HALF_LOG_2PI \
        - torch.log(scale * (1 - y ** 2) + sac.EPS)
    return (y * scale + bias) * mask, (log_prob * mask).sum(-1, keepdim=True), \
        (torch.tanh(mean) * scale + bias) * mask


class MaskedAgents(sac.Agents):
    """:class:`benchmark.reference.sac.Agents` whose policy samples through
    :func:`masked_sample`."""

    def __init__(self, nets, lr: float, mm, mask: torch.Tensor):
        super().__init__(nets, lr, mm)
        self.mask = mask

    def update(self, batch, noise, scale, bias, *, alpha: float, discount: float, tau: float,
               fault: str = None) -> Dict[str, torch.Tensor]:
        mm, mask = self.mm, self.mask
        o, a, r, n, d = batch
        noise_next, noise_pi = noise
        if fault == "half_batch":
            half = o.shape[1] // 2
            o, a, r, n, d = (x[:, :half] for x in (o, a, r, n, d))
            noise_next, noise_pi = noise_next[:, :half], noise_pi[:, :half]
        with torch.no_grad():
            next_a, next_logp, _ = masked_sample(self.policy, n, noise_next, scale, bias, mask, mm)
            target_q = torch.minimum(sac.q_value(self.q1_target, n, next_a, mm),
                                     sac.q_value(self.q2_target, n, next_a, mm)) - alpha * next_logp
            y = r[..., None] + (1 - d[..., None]) * discount * target_q
        losses = {}
        for name in ("q1", "q2"):
            p = getattr(self, name)
            loss = sac.huber(sac.q_value(p, o, a, mm), y).mean(dim=(1, 2))
            self._step(name, torch.autograd.grad(loss.sum(), list(p.values())), fault)
            losses[name] = loss.detach()
        p = self.policy
        new_a, logp, _ = masked_sample(p, o, noise_pi, scale, bias, mask, mm)
        q1, q2 = ({k: v.detach() for k, v in q.items()} for q in (self.q1, self.q2))
        q_new = torch.minimum(sac.q_value(q1, o, new_a, mm), sac.q_value(q2, o, new_a, mm))
        loss = (alpha * logp - q_new).mean(dim=(1, 2))
        self._step("policy", torch.autograd.grad(loss.sum(), list(p.values())), fault)
        losses["policy"] = loss.detach()
        with torch.no_grad():
            for tgt, src in ((self.q1_target, self.q1), (self.q2_target, self.q2)):
                for k in tgt:
                    tgt[k] = tgt[k] * (1 - tau) + src[k] * tau
        return losses


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
    net: torch.Tensor = None              # (steps, D, B) net consumption of every recorded step
    ev_soc: torch.Tensor = None           # (K + 1, D, V) the EVs' SOC before each step of call 1 and after it
    state: Dict[str, torch.Tensor] = None  # after the first call (see :func:`state_of`)
    resets: List[Dict[str, torch.Tensor]] = field(default_factory=list)  # each reset's new state


STATE_KEYS = ("soc", "eff", "deg", "ev_soc", "ev_eff", "ev_deg", "wm")


def state_of(s: ev_district.State) -> Dict[str, torch.Tensor]:
    """The district state as the comparison reads it."""
    out = {"offset": s.offset.clone(), "t": torch.tensor(s.t)}
    out.update({k: getattr(s, k).clone() for k in STATE_KEYS})
    return out


class ReferenceEVScanTrainer(ReferenceScanTrainer):
    """Follows ``train(chunk, chunk=chunk)`` calls from a fresh trainer
    whose networks hold ``nets``. ``precision='tf32'`` is the control;
    ``fault`` one of :data:`FAULTS`, planted here in the program's place;
    ``actions`` forces the steps' actions (one (D, B, M) tensor a step)."""

    def __init__(self, schema_path: str, job: Job, seed: int, nets, device, precision="fp32",
                 fault: str = None, actions: Sequence[torch.Tensor] = None):
        self.job, self.device, self.fault = job, device, fault
        self.district = d = ev_district.load(schema_path, device, job.episode_time_steps)
        self.B = d.n_buildings
        self.obs = ev_district.observation_table(d)                       # (T, B*K)
        self.K = self.obs.shape[1] // self.B
        self.M = d.n_slots
        self.low, self.high, mask = ev_district.action_bounds(d)
        self.scale, self.bias = (self.high - self.low) / 2.0, (self.high + self.low) / 2.0
        self.S_ep = job.episode_time_steps - 1
        self.max_offset = d.base.n_rows - job.episode_time_steps
        self.draws = Draws(seed, device)
        self.mm = sac.MATMULS[precision]
        self.agents = MaskedAgents(nets, job.lr, self.mm, mask)
        D, B, S = job.n_districts, self.B, job.replay_slots
        self.S = S
        z = lambda *s: torch.zeros(s, device=device)
        self.r_obs, self.r_next = z(S, D, B * self.K), z(S, D, B * self.K)
        self.r_act, self.r_rew, self.r_done = z(S, D, B, self.M), z(S, D, B), z(S, D)
        self.pos, self.full, self.step, self.phase = 0, False, 0, 0
        self.state = ev_district.initial(d, self.draws.offsets(0, INIT, D, self.max_offset))
        self.record = Record()
        self.forced = list(actions) if actions is not None else None
        self.steps: List[Dict[str, torch.Tensor]] = []   # every step's rows, rewards, ...

    def train_call(self):
        """One ``train(chunk, chunk=chunk)``: ``chunk`` steps, each
        followed by its update."""
        self.record.losses.append([])
        first = self.step == 0
        for _ in range(self.job.chunk):
            self._step_once(record_policy=first)
        rec = self.record
        rec.net, rec.actions = self.stacked("net"), self.stacked("action")
        if first:
            rec.rewards = self.stacked("reward")
            rec.ev_soc = torch.cat([self.stacked("ev_soc_before"),
                                    self.state.ev_soc[None].clone()])
            rec.state = state_of(self.state)

    def _own_action(self, t: int, obs: torch.Tensor) -> torch.Tensor:
        a = policy_action(self, t, obs, self.agents.policy, self.mm)
        if self.fault == "altered_action":
            # district 0, building 0: the battery's action reversed where it is made
            a = a.clone()
            a[0, 0, 0] = -a[0, 0, 0]
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
        fault = self.fault if self.fault in ev_district.FAULTS else None
        new, out = ev_district.step(d, s, a, fault)
        reward = out.reward * job.reward_scale
        next_obs = self.obs[rows + 1]
        terminated = self.phase + 1 == self.S_ep
        episode_t = s.t
        if terminated:
            new = ev_district.initial(d, self.draws.offsets(t, RESET, job.n_districts,
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
        self.steps.append({"t": torch.tensor(t), "episode_t": episode_t, "rows": rows,
                           "reward": reward, "action": a, "net": out.net,
                           "ev_soc_before": s.ev_soc.clone(),
                           "done": torch.tensor(float(terminated))})
        self.state, self.step = new, t + 1
        self.phase = 0 if terminated else self.phase + 1


def reward_of(tr: ReferenceEVScanTrainer, step: dict, net: torch.Tensor, soc_before: torch.Tensor,
              soc_after: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """The reference's scaled EV reward (D, B) at one of its steps, of the
    given net consumption, EV SOCs before and after the hour, and actions
    (D, B, M) (the program's own, to hold the reward function apart from
    the physics that feeds it)."""
    d = tr.district
    slots = [ev_district._slot(d, f"electric_vehicle_storage_{c.name}") for c in d.chargers]
    a_ch = torch.stack([action[:, b, m] for b, m in slots], 1)
    return ev_district.ev_reward(d, step["episode_t"], net, soc_before, soc_after, a_ch) \
        * tr.job.reward_scale
