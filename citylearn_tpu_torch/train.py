"""Batched SAC training: thousands of district copies feeding
per-building learners on one CUDA card.

The port of ``citylearn_tpu/train.py``'s ``BatchedSAC`` (the reference's
per-building SAC, ``citylearn/agents/sac.py``, scaled out over a district
batch). It trains on every district family the port evaluates —
battery+PV, thermal storage, EV chargers and washing machines, LSTM
dynamics, the EULP and quebec neighborhoods — and is held against the
JAX trainer on each (``tests/test_torch_train*.py``):

- **Every district's experience is learned from.** The replay buffer is
  laid out (S, D, ...) — S slots x D districts — and each env step writes
  all D districts' transitions into one slot. Observations are stored
  flattened, (S, D, A * K), as the JAX package stores them. Sampling
  draws uniform (slot, district) pairs.
- **Districts are de-correlated**: exploration and policy noise are per
  district, and when the dataset is longer than the episode every
  district draws its own episode window offset at each reset.
- **Heterogeneous districts train.** Buildings with different observation
  and action sets are stacked by padding: encoders to a common width,
  actions to a common width with a per-building mask (padded dims act 0).
  Each (building, action slot) routes to a building-level action, a
  charger's ``electric_vehicle_storage`` or a washing machine by a static
  one-hot einsum.
- **Two collect paths, one result.** The per-step path runs
  :func:`citylearn_tpu_torch.core.step.district_step` once per env step,
  on every family (on the card a replay of the trainer's CUDA graph of
  it, :mod:`citylearn_tpu_torch.core.step_graph`). On battery+PV
  districts the chunked path instead runs a whole chunk of K steps as
  one batched policy sweep plus one launch of the collect kernel K2
  (:func:`citylearn_tpu_torch.ops.collect.battery_collect_chunk`), then
  the chunk's K updates. Both draw the same random numbers (below),
  so their warmup transitions agree bit for bit in the actions.

Random numbers. The JAX trainer replays a per-step key chain so that
both paths draw alike. Here :class:`StepDraws` gives every trainer step
``t`` and purpose (explore, act, sample, update, reset, and the
coordination ring of :mod:`citylearn_tpu_torch.train_marlisa`) a generator
seeded from ``(seed, t, purpose)``: a draw depends only on its step,
purpose and shape, never on the order in which a path issues it.
``torch`` streams never match ``jax.random``'s, so the tests feed
JAX-drawn numbers into the port through a :class:`StepDraws` subclass.

The step counter, the replay position and the episode phase are host
integers: whether an update runs is known on the host, so no update
needs a device sync; the trainer syncs once per chunk, to read the
reward sum. Unlike the JAX package's functional updates, the replay
buffers and the networks are updated in place.

Districts shard over GPUs with ``mesh=`` (a
:class:`citylearn_tpu_torch.parallel.DistrictMesh`, one process per GPU),
as the JAX trainer shards them over a ``dp`` mesh
(``citylearn_tpu/train.py:295-310``): the district state, the carried
observations and the replay's district axis hold this rank's rows only,
while the networks and their Adam states are replicated. Every (D, ...)
draw is made at the global D and the rank takes its rows, so a seed gives
each district the same numbers with or without a mesh; the collect steps
the rank's districts (K2 launches once per chunk per rank); an update
draws the same global replay rows on every rank, each rank fills in the
rows it owns, and one ``all_reduce`` of one flat buffer gives every rank
the whole batch, on which every rank runs the identical update. The batch
(~0.3 MB at 256 rows) is reduced rather than the gradients (~4-5 MB at
256x256 for 5 agents), and a sum of one value and zeros leaves no
reduction order to drift: the replicas stay bit-identical.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device, tracing
from citylearn_tpu_torch.agents.sac import (
    AgentNets,
    make_agent_nets,
    nets_from_numpy,
    policy_sample,
    sac_update,
)
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import rollout_fast
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.obs_encoder import (
    build_encoder_spec,
    encode_obs,
    pad_encoder_specs,
    stack_encoder_specs,
)
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.core.rollout import ACTION_KEYS, batched_initial_states
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.core.step_graph import StepGraph
from citylearn_tpu_torch.core.types import EnvState, map_tensors
from citylearn_tpu_torch.ops.collect import battery_collect_chunk, prepare_battery_collect
from citylearn_tpu_torch.parallel.mesh import (
    all_reduce,
    broadcast,
    district_slice,
    gather_districts,
)


class TrainConfig(NamedTuple):
    n_districts: int = 256
    hidden: tuple = (256, 256)
    lr: float = 3e-4
    discount: float = 0.99
    tau: float = 5e-3
    alpha: float = 0.2
    batch_size: int = 256
    replay_capacity: int = 100_000      # total transitions (rounded to D slots)
    warmup_steps: int = 100
    reward_scale: float = 0.2
    # closed-loop collect path: "auto" routes eligible configs (battery+PV
    # family, n_districts % 128 == 0) to the chunked collect kernel K2;
    # "scan" forces the per-step path; "kernel" asserts eligibility
    collect: str = "auto"
    collect_chunk: int = 64             # env steps per collect chunk


@dataclasses.dataclass
class TrainState:
    env_state: EnvState               # (D, ...) district states
    nets: AgentNets                   # stacked over the agent axis A
    replay_obs: torch.Tensor          # (S, D, A * K)
    replay_act: torch.Tensor          # (S, D, A, M)
    replay_rew: torch.Tensor          # (S, D, A)
    replay_next: torch.Tensor         # (S, D, A * K)
    replay_done: torch.Tensor         # (S, D)
    replay_pos: int                   # slot the next transition goes to
    replay_full: bool
    step: int                         # env steps taken
    cur_obs: torch.Tensor             # (D, A, K) encoded obs of env_state

    BUFFERS = ("replay_obs", "replay_act", "replay_rew", "replay_next", "replay_done",
               "cur_obs")


def _env_state_from(tree, dev) -> EnvState:
    t = lambda x: torch.tensor(np.asarray(x), device=dev)
    return EnvState(**{f.name: tuple(t(x) for x in v) if isinstance(v, tuple) else t(v)
                       for f in dataclasses.fields(EnvState)
                       for v in (getattr(tree, f.name),)})


def train_state_from_numpy(tree, lr: float = 3e-4, device=None) -> TrainState:
    """The port's :class:`TrainState` from the JAX package's ``TrainState``
    as numpy arrays (``jax.tree_util.tree_map(np.asarray, trainer.state)``):
    env state, networks and Adam state, replay, position and step. The
    JAX key has no counterpart: the port's draws follow from its seed and
    the step."""
    dev = resolve_device(device)
    t = lambda x: torch.tensor(np.asarray(x), device=dev)
    return TrainState(env_state=_env_state_from(tree.env_state, dev),
                      nets=nets_from_numpy(tree.nets, lr, dev),
                      **{k: t(getattr(tree, k)) for k in TrainState.BUFFERS},
                      replay_pos=int(tree.replay_pos), replay_full=bool(tree.replay_full),
                      step=int(tree.step))


class StepDraws:
    """The trainer's random numbers, each from a generator seeded by
    (seed, step, purpose)."""

    EXPLORE, ACT, SAMPLE, UPDATE, RESET, INIT, EVAL = range(7)
    RING = 7               # after the others, so that their draws stay as they were

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = device

    def generator(self, t: int, purpose: int) -> torch.Generator:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + int(t)) * 16 + purpose)
        return g

    def explore(self, t: int, low: torch.Tensor, high: torch.Tensor, n: int) -> torch.Tensor:
        """(n, A, M) uniform exploration actions in [low, high)."""
        u = torch.rand((n,) + tuple(low.shape), generator=self.generator(t, self.EXPLORE),
                       device=self.device)
        return low + u * (high - low)

    def act_noise(self, t: int, shape) -> torch.Tensor:
        """Standard normal policy noise, (D, A, M)."""
        return torch.randn(shape, generator=self.generator(t, self.ACT), device=self.device)

    def ring_noise(self, t: int, shape) -> torch.Tensor:
        """Standard normal noise of a coordination ring, (iterations, A, D, M)."""
        return torch.randn(shape, generator=self.generator(t, self.RING), device=self.device)

    def sample(self, t: int, n: int, n_slots: int, n_districts: int):
        """Replay rows of an update: n (slot, district) index pairs."""
        g = self.generator(t, self.SAMPLE)
        sel_s = torch.randint(0, max(n_slots, 1), (n,), generator=g, device=self.device)
        sel_d = torch.randint(0, n_districts, (n,), generator=g, device=self.device)
        return sel_s, sel_d

    def update_noise(self, t: int, shape):
        """Noise of an update's next-action and policy-loss samples."""
        g = self.generator(t, self.UPDATE)
        noise = torch.randn((2,) + tuple(shape), generator=g, device=self.device)
        return noise[0], noise[1]

    def offsets(self, t: int, purpose: int, n: int, max_offset: int) -> torch.Tensor:
        """(n,) episode window offsets in [0, max_offset]."""
        if max_offset <= 0:
            return torch.zeros((n,), dtype=torch.int32, device=self.device)
        return torch.randint(0, max_offset + 1, (n,), generator=self.generator(t, purpose),
                             device=self.device, dtype=torch.int32)


class BatchedSAC:
    """Vectorized SAC over ``n_districts`` instances of one dataset, on
    ``device`` (the CUDA card by default)."""

    extra_obs_dim = 0      # policy-input dims a coordinating subclass appends

    def __init__(self, schema, cfg: TrainConfig = TrainConfig(), seed: int = 0,
                 device=None, mesh=None, **schema_kwargs):
        self.cfg = cfg
        # without a mesh, a world of one that holds every district
        self.mesh = rollout_fast.as_mesh(mesh, device)
        self.device = dev = self.mesh.device
        # this rank's rows of the global district batch
        self.rows = district_slice(self.mesh, cfg.n_districts)
        self.n_local = self.rows.stop - self.rows.start
        schema_kwargs.setdefault("central_agent", False)
        self.spec = compile_schema(schema, **schema_kwargs)
        if self.spec.central_agent:
            raise ValueError("BatchedSAC trains per-building agents (decentralized)")
        self.env_cfg, self.params, self.layout = pack(self.spec, device=dev)
        B = self.env_cfg.n_buildings

        # --- observations: per-building encoders padded to a common width,
        # and the whole range encoded once: the policy input is the
        # data-driven obs_static row, so a step's observations are a
        # gather of this (T, A * K) table ---
        self.enc_stack = stack_encoder_specs(pad_encoder_specs(
            [build_encoder_spec(self.spec, self.layout, i, device=dev) for i in range(B)]))
        self.enc_dim = int(self.enc_stack.src.shape[-1])
        self.obs_dim = self.enc_dim + self.extra_obs_dim
        obs_static = self.params.obs_static
        self._enc_table = encode_obs(self.enc_stack, obs_static).reshape(
            obs_static.shape[0], -1)

        # --- actions: padded to a common width with a mask; each (building,
        # slot) routes to its env action — a building-level key, a charger
        # or a washing machine — by one-hot (A, M, n) tensors ---
        names = [list(b.active_actions) for b in self.spec.buildings]
        M = max(len(n) for n in names)
        self.act_dim = M
        C, W = self.env_cfg.n_chargers, self.env_cfg.n_washing_machines
        act_low = np.zeros((B, M), np.float32)
        act_high = np.zeros((B, M), np.float32)
        act_mask = np.zeros((B, M), np.float32)
        w_bld = np.zeros((B, M, len(ACTION_KEYS)), np.float32)
        w_ch = np.zeros((B, M, max(C, 1)), np.float32)
        w_wm = np.zeros((B, M, max(W, 1)), np.float32)
        # district-wide charger and machine indices, in building order
        ch_slot = {(b.index, f"electric_vehicle_storage_{ch.charger_id}"): i
                   for i, (b, ch) in enumerate((b, ch) for b in self.spec.buildings
                                               for ch in b.chargers)}
        wm_slot = {(b.index, wm.name): i
                   for i, (b, wm) in enumerate((b, wm) for b in self.spec.buildings
                                               for wm in b.washing_machines)}
        for bi, b in enumerate(self.spec.buildings):
            act_low[bi, :len(names[bi])] = np.asarray(b.action_low, np.float32)
            act_high[bi, :len(names[bi])] = np.asarray(b.action_high, np.float32)
            act_mask[bi, :len(names[bi])] = 1.0
            for m, k in enumerate(names[bi]):
                if k in ACTION_KEYS:
                    w_bld[bi, m, ACTION_KEYS.index(k)] = 1.0
                elif (bi, k) in ch_slot:
                    w_ch[bi, m, ch_slot[(bi, k)]] = 1.0
                elif (bi, k) in wm_slot:
                    w_wm[bi, m, wm_slot[(bi, k)]] = 1.0
                else:
                    raise NotImplementedError(f"trainer action routing for {k}")
        t = lambda a: torch.tensor(a, device=dev)
        self.act_low, self.act_high, self.act_mask = t(act_low), t(act_high), t(act_mask)
        self.action_scale = (self.act_high - self.act_low) / 2.0
        self.action_bias = (self.act_high + self.act_low) / 2.0
        self.w_bld = t(w_bld)
        self.w_ch = t(w_ch) if C else None
        self.w_wm = t(w_wm) if W else None

        # per-district episode windows: when the dataset's simulation range
        # exceeds the episode length, each district rolls its own seeded
        # window (reference EpisodeTracker splits, base.py:76-129)
        self.max_offset = int(self.spec.simulation_time_steps - self.env_cfg.time_steps)
        if self.env_cfg.has_stochastic_outage:
            # the baked stochastic-outage signal covers the default window
            # only (core/params.py): shifted windows would read zeros
            self.max_offset = 0

        self.draws = StepDraws(seed, dev)
        # the per-step collect's CUDA graph of district_step (core/step_graph.py)
        self._step_graph = StepGraph()
        self._init_state(seed)

        # ---- closed-loop kernel collect (battery+PV family) ----
        self.use_kernel_collect = self._kernel_collect_eligible()
        if cfg.collect == "kernel" and not self.use_kernel_collect:
            raise ValueError("collect='kernel' requires a battery+PV-family config "
                             "(rollout_fast.eligible), n_districts a multiple of 128 x the "
                             "mesh's ranks and no coordination observations")
        if self.use_kernel_collect:
            self._collect_prep = prepare_battery_collect(self.env_cfg, self.params)

    # ------------------------------------------------------------------
    def _mine(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``x``, made at the global batch size, along
        the district axis ``dim``."""
        return x.narrow(dim, self.rows.start, self.n_local)

    def _gathered(self, table):
        """A KPI table of this rank's districts -> the global batch's."""
        return {k: gather_districts(self.mesh, v) for k, v in table.items()}

    def _broadcast_initial(self, offsets: torch.Tensor) -> EnvState:
        st = batched_initial_states(self.env_cfg, self.params, offsets.shape[0],
                                    device=self.device)
        return dataclasses.replace(st, data_offset=offsets)

    def _init_state(self, seed: int):
        self.load_state(self._fresh_state(seed))

    def _fresh_state(self, seed: int) -> TrainState:
        cfg = self.cfg
        A = self.env_cfg.n_buildings
        D, n = cfg.n_districts, self.n_local
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        nets = make_agent_nets(A, self.obs_dim, self.act_dim, list(cfg.hidden), cfg.lr,
                               gen, self.device)
        env_state = self._broadcast_initial(
            self._mine(self.draws.offsets(0, StepDraws.INIT, D, self.max_offset)))
        # replay slots of D rows each, a rank holding its n of every slot's
        # rows: the same slot count on every rank as without a mesh
        S = max(1, cfg.replay_capacity // D)
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        return TrainState(
            env_state=env_state, nets=nets,
            replay_obs=zeros(S, n, A * self.obs_dim),
            replay_act=zeros(S, n, A, self.act_dim),
            replay_rew=zeros(S, n, A),
            replay_next=zeros(S, n, A * self.obs_dim),
            replay_done=zeros(S, n),
            replay_pos=0, replay_full=False, step=0,
            cur_obs=self._encoded_obs(env_state))

    @property
    def base_state(self) -> TrainState:
        """The SAC part of the trainer's state (a coordinating subclass
        wraps it in a state of its own)."""
        return self.state

    def load_state(self, state):
        """Install ``state`` and re-sync the host-side episode phase from
        it (districts advance in lockstep: any district's ``t`` is it)."""
        self.state = state
        self._phase = int(self.base_state.env_state.t[0])

    # ------------------------------------------------------------------
    def _encoded_obs(self, env_state: EnvState) -> torch.Tensor:
        """(D, A, K) encoded observations at the current step (the
        returned-observation semantics: the data-driven obs_static row)."""
        tau = (env_state.data_offset + env_state.t).long()
        return self._enc_table[tau].view(tau.shape[0], self.env_cfg.n_buildings, -1)

    def _actions_dict(self, a_env: torch.Tensor):
        """(D, A, M) padded masked actions -> the step's action dict: the
        building-level keys (D, B), and on an EV district
        ``electric_vehicle_storage`` (D, C) and ``washing_machine`` (D, W)."""
        # each key's (D, B) rows contiguous, the layout of the step graph's
        # buffers, so that one copy takes all of them into the graph
        bld = torch.einsum("dam,amk->kda", a_env, self.w_bld).contiguous()
        out = {k: bld[i] for i, k in enumerate(ACTION_KEYS)}
        if self.w_ch is not None:
            out["electric_vehicle_storage"] = torch.einsum("dam,amc->dc", a_env, self.w_ch)
        if self.w_wm is not None:
            out["washing_machine"] = torch.einsum("dam,amw->dw", a_env, self.w_wm)
        return out

    def _policy_actions(self, obs: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(N, A, K) observations and (N, A, M) noise -> (N, A, M) sampled
        actions of the current policy."""
        with tracing.span("train.policy"), torch.no_grad():
            act, _, _ = policy_sample(self.state.nets.policy, obs.transpose(0, 1),
                                      noise.transpose(0, 1), self.action_scale,
                                      self.action_bias, self.act_mask)
        return act.transpose(0, 1)

    def _replay_rows(self, sel_s: torch.Tensor, sel_d: torch.Tensor):
        """The replay rows (obs, act, rew, next, done) at the (slot, global
        district) pairs. Under a mesh each rank gathers the rows it owns and
        zeros the rest, and one ``all_reduce`` of one flat buffer gives
        every rank the whole batch: each row is one rank's values plus
        zeros, the same bits on every rank."""
        ts = self.base_state
        bufs = (ts.replay_obs, ts.replay_act, ts.replay_rew, ts.replay_next, ts.replay_done)
        N = sel_s.shape[0]
        local = sel_d - self.rows.start
        owned = (local >= 0) & (local < self.n_local)
        rows = [buf[sel_s, torch.where(owned, local, 0)].reshape(N, -1) for buf in bufs]
        flat = all_reduce(self.mesh, torch.where(owned[:, None], torch.cat(rows, 1), 0.0))
        parts = flat.split([r.shape[1] for r in rows], 1)
        return [x.contiguous().view((N,) + tuple(buf.shape[2:])) for x, buf in zip(parts, bufs)]

    @tracing.traced("train.update")
    def _update(self, t: int, n_slots: int):
        """One SAC update of every agent on a batch drawn from the first
        ``n_slots`` replay slots (all districts)."""
        cfg, ts = self.cfg, self.base_state
        A, N = self.env_cfg.n_buildings, cfg.batch_size
        with tracing.span("train.draws"):
            rows = self.draws.sample(t, N, n_slots, cfg.n_districts)
            noise = self.draws.update_noise(t, (A, N, self.act_dim))
        with tracing.span("train.replay"):
            obs, act, rew, nxt, done = self._replay_rows(*rows)
        agents_first = lambda x: x.view(N, A, -1).transpose(0, 1)
        batch = (agents_first(obs), act.transpose(0, 1), rew.t(), agents_first(nxt),
                 done[None].expand(A, N))
        sac_update(ts.nets, batch, noise, self.action_scale, self.action_bias, self.act_mask,
                   alpha=cfg.alpha, discount=cfg.discount, tau=cfg.tau)

    def _store(self, idx, obs, act, rew, nxt, done):
        ts = self.base_state
        ts.replay_obs[idx] = obs
        ts.replay_act[idx] = act
        ts.replay_rew[idx] = rew
        ts.replay_next[idx] = nxt
        ts.replay_done[idx] = done

    # ------------------------------------------------------------------
    # per-step collect
    # ------------------------------------------------------------------
    @tracing.traced("train.step")
    def _scan_step(self) -> torch.Tensor:
        cfg, ts = self.cfg, self.state
        D, n = cfg.n_districts, self.n_local
        t = ts.step
        obs = ts.cur_obs                                       # (n, A, K)
        explore = t < cfg.warmup_steps
        if explore:
            a_env = self._mine(self.draws.explore(t, self.act_low, self.act_high, D))
        else:
            a_env = self._policy_actions(
                obs, self._mine(self.draws.act_noise(t, (D,) + self.act_low.shape)))
        actions = self._actions_dict(a_env)
        with self._step_graph.engaged():
            env_state, out = district_step(self.env_cfg, self.params, ts.env_state, actions)
        reward = out.reward * cfg.reward_scale                 # (n, A)
        next_obs = self._encoded_obs(env_state)

        # episode auto-reset with freshly drawn windows (termination is
        # time-driven, so all districts reset together)
        terminated = self._phase + 1 == self.env_cfg.time_steps - 1
        if terminated:
            env_state = self._broadcast_initial(
                self._mine(self.draws.offsets(t, StepDraws.RESET, D, self.max_offset)))
            cur_obs = self._encoded_obs(env_state)
        else:
            cur_obs = next_obs

        slot = ts.replay_pos
        S = ts.replay_done.shape[0]
        self._store(slot, obs.reshape(n, -1), a_env, reward, next_obs.reshape(n, -1),
                    float(terminated))
        ts.replay_pos = (slot + 1) % S
        ts.replay_full = ts.replay_full or slot + 1 >= S

        # SAC updates once the buffer has a batch
        slots_avail = S if ts.replay_full else ts.replay_pos
        if slots_avail * D >= cfg.batch_size and not explore:
            self._update(t, slots_avail)
        ts.env_state, ts.cur_obs = env_state, cur_obs
        ts.step = t + 1
        self._phase = 0 if terminated else self._phase + 1
        return reward.sum()

    # ------------------------------------------------------------------
    # chunked collect on the kernel: one policy sweep over the chunk, one
    # K2 launch, then the chunk's updates. Semantics vs _scan_step: the
    # same draws, transitions and battery state (bit-equal actions during
    # warmup); the one deliberate difference is actor-learner lag — the
    # whole chunk acts with the chunk-start policy, then the chunk's
    # updates run, where the per-step path updates after every step.
    # ------------------------------------------------------------------
    def _kernel_collect_eligible(self) -> bool:
        # n_districts % (128 x shards) is the JAX package's lane-tile rule;
        # it is no tile width here (K2 takes any D) and is kept so that a
        # configuration takes the same path in both packages
        return (self.cfg.collect != "scan"
                and rollout_fast.eligible(self.env_cfg)
                and self.cfg.n_districts % (128 * self.mesh.world_size) == 0
                and self.extra_obs_dim == 0)

    @tracing.traced("train.chunk")
    def _collect_chunk(self, kc: int, first_chunk: bool, do_reset: bool) -> torch.Tensor:
        cfg, ts = self.cfg, self.state
        A, M = self.env_cfg.n_buildings, self.act_dim
        D, n = cfg.n_districts, self.n_local
        t0 = ts.step
        st = ts.env_state
        steps = torch.arange(kc, device=self.device)
        tau = (st.data_offset + st.t).long()[None, :] + steps[:, None]     # (kc, n)
        obs = self._enc_table[tau]                                          # (kc, n, A*K)

        # -- actions: warmup steps explore, the rest sample the chunk-start
        # policy in one sweep over all their districts --
        n_explore = min(max(cfg.warmup_steps - t0, 0), kc)
        a_env = torch.empty((kc, n, A, M), device=self.device)
        for k in range(n_explore):
            a_env[k] = self._mine(self.draws.explore(t0 + k, self.act_low, self.act_high, D))
        if n_explore < kc:
            noise = torch.stack([self._mine(self.draws.act_noise(t0 + k, (D, A, M)))
                                 for k in range(n_explore, kc)])
            n_act = kc - n_explore
            a_env[n_explore:] = self._policy_actions(
                obs[n_explore:].reshape(n_act * n, A, -1), noise.view(n_act * n, A, M)
            ).view(n_act, n, A, M)

        # -- env recurrence: one K2 launch over the chunk --
        es = torch.einsum("kdam,am->kda", a_env,
                          self.w_bld[:, :, ACTION_KEYS.index("electrical_storage")])
        ser = self.params.series
        rew_b, soc, eff, deg = battery_collect_chunk(
            self._collect_prep, es.contiguous(), ser.non_shiftable_load[tau],
            ser.solar_generation[tau], st.battery_soc, st.battery_efficiency,
            st.battery_degraded_capacity, first_chunk=first_chunk)
        reward = rew_b * cfg.reward_scale                                  # (kc, n, A)

        # next_obs: the following step's row (pre-reset at the episode
        # boundary, as the per-step path stores it)
        obs_next_last = self._enc_table[tau[-1] + 1]                        # (n, A*K)
        next_obs = torch.cat([obs[1:], obs_next_last[None]])

        # -- replay ring writes --
        S = ts.replay_done.shape[0]
        slot = ts.replay_pos
        done = torch.zeros((kc, n), device=self.device)
        if do_reset:
            done[-1] = 1.0
        self._store((slot + steps) % S, obs, a_env, reward, next_obs, done)
        ts.replay_pos = (slot + kc) % S
        ts.replay_full = ts.replay_full or slot + kc >= S

        # -- the chunk's updates, at the per-step cadence; as in the JAX
        # package, an update may sample any transition of this chunk --
        for k in range(n_explore, kc):
            slots_avail = S if ts.replay_full else (slot + k + 1) % S
            if slots_avail * D >= cfg.batch_size:
                self._update(t0 + k, slots_avail)

        # -- post-chunk env state + carried observation --
        if do_reset:
            ts.env_state = self._broadcast_initial(self._mine(
                self.draws.offsets(t0 + kc - 1, StepDraws.RESET, D, self.max_offset)))
            ts.cur_obs = self._encoded_obs(ts.env_state)
        else:
            ts.env_state = dataclasses.replace(
                st, t=st.t + kc, battery_soc=soc, battery_efficiency=eff,
                battery_degraded_capacity=deg)
            ts.cur_obs = obs_next_last.view(n, A, -1)
        ts.step = t0 + kc
        return reward.sum()

    def _train_kernel_chunk(self, n: int) -> float:
        """Run ``n`` env steps through episode-aligned kernel-collect
        chunks; returns the summed (scaled) reward over them."""
        S_ep = self.env_cfg.time_steps - 1
        S_slots = int(self.state.replay_done.shape[0])
        total = 0.0
        left = n
        while left > 0:
            kc = min(left, self.cfg.collect_chunk, S_ep - self._phase, S_slots)
            do_reset = self._phase + kc == S_ep
            reward = self._collect_chunk(kc, self._phase == 0, do_reset)
            with tracing.span("train.readback"):
                total += float(all_reduce(self.mesh, reward))
            self._phase = 0 if do_reset else self._phase + kc
            left -= kc
        return total

    # ------------------------------------------------------------------
    @tracing.traced("train.call")
    def train(self, n_steps: int, chunk: int = 200) -> List[float]:
        """Run ``n_steps`` env steps of collect+update; returns the mean
        summed reward per step of each chunk. Battery+PV-family configs
        take the chunked kernel collect (``use_kernel_collect``); others
        the per-step path. Under a mesh the rewards are summed over
        every rank's districts."""
        history = []
        remaining = n_steps
        while remaining > 0:
            n = min(chunk, remaining)
            if self.use_kernel_collect:
                history.append(self._train_kernel_chunk(n) / n)
            else:
                rewards = torch.stack([self._scan_step() for _ in range(n)])
                with tracing.span("train.readback"):
                    history.append(float(all_reduce(self.mesh, rewards).mean()))
            remaining -= n
        return history

    def evaluate(self, n_steps: int = None, baseline_condition: str = "_without_storage",
                 policy=None):
        """KPI tables for every district under the current deterministic
        policy, on fresh districts with freshly drawn windows (the
        reference's ``citylearn.py:1136-1323`` semantics through
        :func:`citylearn_tpu_torch.core.evaluate.evaluate_districts`).
        Returns ``district|<kpi>`` -> (D,) and ``building|<kpi>`` -> (D, B).

        ``policy`` may be a
        :class:`citylearn_tpu_torch.core.evaluate_fast.ScriptedPolicy` (e.g.
        an RBC baseline to compare the learned policy against): that
        evaluation runs on fresh default-window districts and, on
        kernel-eligible configurations, as one whole-episode kernel launch
        through the ``evaluate_districts`` dispatch.

        Under a mesh each rank evaluates its districts and the tables are
        gathered: every rank returns the global batch's."""
        D, n = self.cfg.n_districts, self.n_local
        if policy is not None:
            states = batched_initial_states(self.env_cfg, self.params, n, device=self.device)
            return self._gathered(evaluate_districts(
                self.env_cfg, self.params, states, policy, n_steps, baseline_condition,
                device=self.device))

        fresh = self._broadcast_initial(self._mine(
            self.draws.offsets(self.state.step, StepDraws.EVAL, D, self.max_offset)))
        zeros = torch.zeros((n,) + self.act_low.shape, device=self.device)

        def policy_fn(params, states):
            with torch.no_grad():
                _, _, det = policy_sample(
                    self.state.nets.policy, self._encoded_obs(states).transpose(0, 1),
                    zeros.transpose(0, 1), self.action_scale, self.action_bias,
                    self.act_mask)
            return self._actions_dict(det.transpose(0, 1))

        return self._gathered(evaluate_districts(self.env_cfg, self.params, fresh, policy_fn,
                                                 n_steps, baseline_condition,
                                                 device=self.device))

    # ------------------------------------------------------------------
    def _write(self, write):
        """Run ``write()`` on rank 0 alone, while the mesh's other ranks
        wait until it has written (and raise if it failed)."""
        done = torch.zeros(1, device=self.device)
        try:
            if self.mesh.rank == 0:
                write()
            done += 1
        finally:
            broadcast(self.mesh, done)
        if not float(done):
            raise RuntimeError("rank 0 failed to write")

    def save(self, path: str):
        """Write the networks and their Adam states (replicated under a
        mesh: rank 0 writes)."""
        self._write(lambda: torch.save(self.base_state.nets.state_dict(), path))

    def load(self, path: str):
        self.base_state.nets.load_state_dict(torch.load(path, map_location=self.device))

    # full-state checkpointing (learner + env + replay + step): resumable
    # training needs the whole TrainState, where the reference pickles
    # only agents (__main__.py:291-298)
    CHECKPOINT = "train_state.pt"

    def save_checkpoint(self, directory: str):
        """Write the complete :class:`TrainState`; :meth:`restore_checkpoint`
        resumes from it bit-exactly. Under a mesh the district state and
        the replay are gathered and rank 0 writes the global batch's, which
        restores into a trainer on any number of ranks."""
        ts = self.state
        gather = lambda x, dim=0: gather_districts(self.mesh, x, dim)
        saved = {"env_state": dataclasses.asdict(map_tensors(gather, ts.env_state)),
                 "nets": ts.nets.state_dict(),
                 # the replay's district axis is its second
                 **{k: gather(getattr(ts, k), 0 if k == "cur_obs" else 1)
                    for k in TrainState.BUFFERS},
                 "replay_pos": ts.replay_pos, "replay_full": ts.replay_full,
                 "step": ts.step, "seed": self.draws.seed}

        def write():
            os.makedirs(directory, exist_ok=True)
            torch.save(saved, os.path.join(directory, self.CHECKPOINT))
        self._write(write)

    def restore_checkpoint(self, directory: str):
        saved = torch.load(os.path.join(directory, self.CHECKPOINT),
                           map_location=self.device)
        if saved["cur_obs"].shape[0] != self.cfg.n_districts:
            raise ValueError(f"the checkpoint holds {saved['cur_obs'].shape[0]} districts, "
                             f"the trainer {self.cfg.n_districts}")
        mine = lambda x, dim=0: self._mine(x, dim).contiguous()
        self.state.nets.load_state_dict(saved["nets"])
        self.draws = StepDraws(saved["seed"], self.device)
        self.load_state(TrainState(
            env_state=map_tensors(mine, EnvState(**saved["env_state"])), nets=self.state.nets,
            **{k: mine(saved[k], 0 if k == "cur_obs" else 1) for k in TrainState.BUFFERS},
            replay_pos=saved["replay_pos"], replay_full=saved["replay_full"],
            step=saved["step"]))
