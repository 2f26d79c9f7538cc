"""The batched SAC trainer's first train calls, worked out again in plain
PyTorch: seeded episode windows, exploration and policy actions, the
battery physics of every step of a chunk, the replay ring and the chunk's
updates, as ``BatchedSAC.train(K, chunk=K)`` runs them on a battery+PV
district (``citylearn_tpu_torch/train.py``, kernel collect path); and one
collect chunk followed from a start that the program recorded, the
episode's reset included.

The random numbers are the trainer's seeded draws: a generator seeded with
``(seed * 1_000_003 + step) * 16 + purpose`` for each step and purpose, the
formula of ``StepDraws`` at commit 9d3dc9dcb87c1d4e04504b157550827e94518679,
copied here so that the benchmark hands both sides the same draws.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

from benchmark.reference import battery as battery_model
from benchmark.reference import district as district_model
from benchmark.reference import sac

EXPLORE, ACT, SAMPLE, UPDATE, RESET, INIT = range(6)


class Draws:
    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), device

    def generator(self, t: int, purpose: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + int(t)) * 16 + purpose)
        return g

    def offsets(self, t, purpose, n, max_offset):
        if max_offset <= 0:
            return torch.zeros((n,), dtype=torch.int64, device=self.device)
        return torch.randint(0, max_offset + 1, (n,), generator=self.generator(t, purpose),
                             device=self.device, dtype=torch.int32).long()


@dataclass
class Job:
    """A training job: the trainer's settings as the traffic file gives them."""
    n_districts: int
    hidden: tuple
    batch_size: int
    replay_slots: int
    warmup_steps: int
    chunk: int
    episode_time_steps: int
    lr: float = 3e-4
    discount: float = 0.99
    tau: float = 5e-3
    alpha: float = 0.2
    reward_scale: float = 0.2

    @classmethod
    def of(cls, traffic: dict) -> "Job":
        keys = cls.__dataclass_fields__
        return cls(**{k: tuple(v) if k == "hidden" else v for k, v in traffic.items() if k in keys})


@dataclass
class Record:
    """What the comparison reads of the first calls."""
    losses: List[List[Dict[str, torch.Tensor]]] = field(default_factory=list)  # per call, per update
    first_rewards: torch.Tensor = None      # (K, D, B) scaled rewards written by call 1
    first_actions: torch.Tensor = None      # (K, D, B, M)
    first_state: tuple = None               # (soc, eff, deg) after call 1


class ReferenceTrainer:
    """Follows ``n_calls`` of ``train(chunk, chunk=chunk)`` from a fresh
    trainer whose networks hold ``nets``."""

    def __init__(self, schema_path: str, job: Job, seed: int, nets, device, precision="fp32",
                 fault: str = None):
        self.job, self.device, self.fault = job, device, fault
        d = district_model.load(schema_path)
        self.B = len(d.buildings)
        self.obs = district_model.observation_table(d, device)             # (T, B*K)
        self.nsl, self.solar = district_model.physics_series(d, device)     # (T, B)
        self.bat = battery_model.Batteries.of(d.buildings, device)
        self.hours = d.seconds_per_time_step / 3600.0
        self.K = self.obs.shape[1] // self.B
        self.M = 1
        self.low = -torch.ones(self.B, self.M, device=device)
        self.high = torch.ones(self.B, self.M, device=device)
        self.scale, self.bias = (self.high - self.low) / 2.0, (self.high + self.low) / 2.0
        self.S_ep = job.episode_time_steps - 1
        self.max_offset = d.n_rows - job.episode_time_steps
        self.draws = Draws(seed, device)
        self.agents = sac.Agents(nets, job.lr, sac.MATMULS[precision])
        D, B = job.n_districts, self.B
        self.S = job.replay_slots
        z = lambda *s: torch.zeros(s, device=device)
        self.r_obs, self.r_next = z(self.S, D, B * self.K), z(self.S, D, B * self.K)
        self.r_act, self.r_rew, self.r_done = z(self.S, D, B, self.M), z(self.S, D, B), z(self.S, D)
        self.pos, self.full, self.step, self.phase = 0, False, 0, 0
        self._reset(self.draws.offsets(0, INIT, D, self.max_offset))
        self.record = Record()

    def _reset(self, offsets):
        self.offset = offsets
        self.t = 0
        self.soc, self.eff, self.deg = self._initial()

    def train_call(self):
        """One ``train(chunk, chunk=chunk)``: episode-aligned chunks."""
        self.record.losses.append([])
        left = self.job.chunk
        while left > 0:
            kc = min(left, self.job.chunk, self.S_ep - self.phase, self.S)
            reset = self.phase + kc == self.S_ep
            self._chunk(kc, self.phase == 0, reset)
            self.phase = 0 if reset else self.phase + kc
            left -= kc

    def _initial(self):
        D = self.job.n_districts
        tile = lambda v: v[None].expand(D, self.B).clone()
        return tile(self.bat.initial_soc), tile(self.bat.efficiency), tile(self.bat.capacity)

    def _collect(self, kc, first, t0, offset, t, state, policy):
        """A chunk's rows, observations, actions, rewards and the battery
        state after it, from a start: the window offsets (D,), the
        position in the episode, the battery state and the policy's
        weights."""
        job, dev = self.job, self.device
        D, B, K, M = job.n_districts, self.B, self.K, self.M
        steps = torch.arange(kc, device=dev)
        rows = offset[None, :] + t + steps[:, None]                          # (kc, D)
        obs = self.obs[rows]                                                 # (kc, D, B*K)
        n_explore = min(max(job.warmup_steps - t0, 0), kc)
        acts = torch.empty((kc, D, B, M), device=dev)
        for k in range(n_explore):
            u = torch.rand((D, B, M), generator=self.draws.generator(t0 + k, EXPLORE), device=dev)
            acts[k] = self.low + u * (self.high - self.low)
        if n_explore < kc:
            noise = torch.stack([torch.randn((D, B, M), generator=self.draws.generator(t0 + k, ACT),
                                             device=dev) for k in range(n_explore, kc)])
            n = (kc - n_explore) * D
            a = sac.act(policy, obs[n_explore:].reshape(n, B, K).transpose(0, 1),
                        noise.reshape(n, B, M).transpose(0, 1), self.scale, self.bias,
                        self.agents.mm)
            acts[n_explore:] = a.transpose(0, 1).reshape(kc - n_explore, D, B, M)

        rewards = []
        soc, eff, deg = state
        for k in range(kc):
            energy = acts[k, :, :, 0] * self.bat.nominal_power * self.hours
            soc, eff, deg, balance = battery_model.charge(self.bat, soc, eff, deg, energy)
            nsl, solar = self.nsl[rows[k]], self.solar[rows[k]]
            if first and k == 0:       # the first step of an episode counts load thrice, storage twice
                net = 3.0 * nsl + 2.0 * balance - solar
            else:
                net = nsl + balance - solar
            rewards.append(-torch.clamp(net, min=0.0) * job.reward_scale)
        return rows, obs, acts, torch.stack(rewards), (soc, eff, deg)

    def _done(self, kc, reset):
        done = torch.zeros((kc, self.job.n_districts), device=self.device)
        if reset:
            done[-1] = 1.0
        return done

    def _reset_offsets(self, t_last):
        return self.draws.offsets(t_last, RESET, self.job.n_districts, self.max_offset)

    def _chunk(self, kc, first, reset):
        job, dev = self.job, self.device
        D = job.n_districts
        t0 = self.step
        rows, obs, acts, rewards, (soc, eff, deg) = self._collect(
            kc, first, t0, self.offset, self.t, (self.soc, self.eff, self.deg), self.agents.policy)
        if self.fault == "altered_answer":
            rewards[:, 0, 0] = -rewards[:, 0, 0]
        n_explore = min(max(job.warmup_steps - t0, 0), kc)

        next_obs = torch.cat([obs[1:], self.obs[rows[-1] + 1][None]])
        done = self._done(kc, reset)
        steps = torch.arange(kc, device=dev)
        slots = (self.pos + steps) % self.S
        self.r_obs[slots], self.r_act[slots], self.r_rew[slots] = obs, acts, rewards
        self.r_next[slots], self.r_done[slots] = next_obs, done
        slot = self.pos
        self.pos = (slot + kc) % self.S
        self.full = self.full or slot + kc >= self.S
        if t0 == 0:
            self.record.first_rewards, self.record.first_actions = rewards.clone(), acts.clone()

        for k in range(n_explore, kc):
            avail = self.S if self.full else (slot + k + 1) % self.S
            if avail * D >= job.batch_size:
                self.record.losses[-1].append(self._update(t0 + k, avail))

        if reset:
            self._reset(self._reset_offsets(t0 + kc - 1))
        else:
            self.t += kc
            self.soc, self.eff, self.deg = soc, eff, deg
        self.step = t0 + kc
        if self.record.first_state is None:
            self.record.first_state = (soc.clone(), eff.clone(), deg.clone())

    def follow(self, chunk) -> dict:
        """One collect chunk of the program's, followed from the start the
        program recorded for it (``sac_train.Chunk``: its step count,
        episode position, window offsets, battery state and policy
        weights): the chunk's actions and rewards, its done flags, and the
        state after it, the episode's reset included. Runs no update."""
        _, _, acts, rewards, after = self._collect(
            chunk.kc, chunk.first, chunk.t0, chunk.offset, chunk.t, chunk.state, chunk.policy)
        if chunk.reset:
            offset, t, after = self._reset_offsets(chunk.t0 + chunk.kc - 1), 0, self._initial()
        else:
            offset, t = chunk.offset, chunk.t + chunk.kc
        return {"rewards": rewards, "actions": acts, "done": self._done(chunk.kc, chunk.reset),
                "offset": offset, "t": t, "state": after}

    def _update(self, t, n_slots):
        job, dev = self.job, self.device
        D, B, K, M, N = job.n_districts, self.B, self.K, self.M, job.batch_size
        g = self.draws.generator(t, SAMPLE)
        sel_s = torch.randint(0, max(n_slots, 1), (N,), generator=g, device=dev)
        sel_d = torch.randint(0, D, (N,), generator=g, device=dev)
        noise = torch.randn((2, B, N, M), generator=self.draws.generator(t, UPDATE), device=dev)
        per_agent = lambda x: x.view(N, B, K).transpose(0, 1)
        batch = (per_agent(self.r_obs[sel_s, sel_d]), self.r_act[sel_s, sel_d].transpose(0, 1),
                 self.r_rew[sel_s, sel_d].t(), per_agent(self.r_next[sel_s, sel_d]),
                 self.r_done[sel_s, sel_d][None].expand(B, N))
        return self.agents.update(batch, (noise[0], noise[1]), self.scale, self.bias,
                                  alpha=job.alpha, discount=job.discount, tau=job.tau,
                                  fault=self.fault)
