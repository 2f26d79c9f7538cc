"""Soft actor-critic networks and update, stacked over the agent axis.

The JAX package builds one agent's networks as parameter pytrees and
``vmap``s its functions over the agent axis ``A``
(``citylearn_tpu/agents/sac.py``, ``citylearn_tpu/train.py``). Here each
network is an ``nn.Module`` whose parameters carry that axis: a layer's
weight is (A, in, out) and its input (A, N, in), so one batched matrix
product applies every agent's layer at once. Architecture as the
reference's (``rl.py:13-132``): twin soft-Q networks with LayerNorm, a
tanh-Gaussian policy with action scale and bias, Huber Q loss, Polyak
target updates and Adam.

Gaussian noise is an argument of :func:`policy_sample` and
:func:`sac_update`, so that a caller decides where the random numbers
come from (the trainer's per-step generators, or a test's numpy draws).

The host-loop agents (reference ``citylearn/agents/sac.py``) sit on top:
:class:`SAC` keeps one network set per building agent
(``make_agent_nets(n_agents=1, ...)`` on the env's device) with its own
replay ring and normalization statistics, steps the env through
``learn`` and updates each agent with :func:`sac_update`; :class:`SACRBC`
explores with a rule-based controller.

On CUDA inputs :func:`sac_update` replays one CUDA graph of the whole
update (targets, both critics, the policy, both Adam steps, Polyak)
(:mod:`citylearn_tpu_torch.graphs`); elsewhere it runs the update
eagerly. Each pair of critics, (q1, q2) or their targets, goes through
one twin pass (:func:`citylearn_tpu_torch.ops.twin_q.twin_q`): on the
card a set of hand-written kernels, a launch a layer for both.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Any, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from citylearn_tpu_torch import resolve_device, tracing
from citylearn_tpu_torch.agents.rbc import RBC, BasicRBC
from citylearn_tpu_torch.agents.rlc import RLC
from citylearn_tpu_torch.graphs import Graph
from citylearn_tpu_torch.ops.twin_q import twin_q
from citylearn_tpu_torch.preprocessing import RemoveFeature, encode

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
EPS = 1e-6
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8     # optax.adam's defaults
# 0.5 * log(2 pi) rounded as the JAX package rounds it: a float32 log
HALF_LOG_2PI = float(0.5 * np.log(np.float32(2 * np.pi)))


def _uniform(shape, bound: float, generator: torch.Generator, device) -> nn.Parameter:
    u = torch.rand(shape, generator=generator, device=device)
    return nn.Parameter(u * (2.0 * bound) - bound)


def _mlp_init(n_agents: int, sizes: Sequence[int], generator: torch.Generator, device,
              init_w: float = 3e-3, final_uniform: bool = True
              ) -> Tuple[nn.ParameterList, nn.ParameterList]:
    """Weights (A, in, out) and biases (A, out) of an MLP: torch
    ``nn.Linear``'s U(-1/sqrt(fan_in), 1/sqrt(fan_in)), and U(-init_w,
    init_w) for the last layer when ``final_uniform``."""
    ws, bs = nn.ParameterList(), nn.ParameterList()
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        bound = init_w if last and final_uniform else 1.0 / math.sqrt(fan_in)
        ws.append(_uniform((n_agents, fan_in, fan_out), bound, generator, device))
        bs.append(_uniform((n_agents, fan_out), bound, generator, device))
    return ws, bs


def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A, N, in) @ (A, in, out) + (A, out) -> (A, N, out)."""
    return torch.matmul(x, w) + b[:, None, :]


class SoftQ(nn.Module):
    """SoftQNetwork (``rl.py:115-132``) for A agents: ln(relu(linear)) per
    hidden layer, then a linear head to one value."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int, hidden: Sequence[int],
                 generator: torch.Generator = None, device=None):
        super().__init__()
        self.w, self.b = _mlp_init(n_agents, [obs_dim + act_dim, *hidden, 1],
                                   generator, device)
        self.ln_scale = nn.ParameterList(
            [nn.Parameter(torch.ones(n_agents, h, device=device)) for h in hidden])
        self.ln_bias = nn.ParameterList(
            [nn.Parameter(torch.zeros(n_agents, h, device=device)) for h in hidden])

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        """(A, N, K), (A, N, M) -> (A, N, 1)."""
        x = torch.cat([obs, act], dim=-1)
        for i in range(len(self.ln_scale)):
            x = torch.relu(_linear(x, self.w[i], self.b[i]))
            # LayerNorm written out as the JAX package does, biased variance
            mean = x.mean(-1, keepdim=True)
            var = ((x - mean) ** 2).mean(-1, keepdim=True)
            x = ((x - mean) / torch.sqrt(var + 1e-5) * self.ln_scale[i][:, None]
                 + self.ln_bias[i][:, None])
        return _linear(x, self.w[-1], self.b[-1])

    def jax_paths(self) -> List[Tuple[tuple, nn.Parameter]]:
        """(path into the JAX package's parameter tree, parameter) pairs."""
        n = len(self.w)
        return ([(("layers", i, "w"), self.w[i]) for i in range(n)]
                + [(("layers", i, "b"), self.b[i]) for i in range(n)]
                + [(("ln", i, "scale"), p) for i, p in enumerate(self.ln_scale)]
                + [(("ln", i, "bias"), p) for i, p in enumerate(self.ln_bias)])


class Policy(nn.Module):
    """Tanh-Gaussian policy trunk and heads (``rl.py:13-68``) for A agents."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int, hidden: Sequence[int],
                 generator: torch.Generator = None, device=None):
        super().__init__()
        self.trunk_w, self.trunk_b = _mlp_init(n_agents, [obs_dim, *hidden], generator,
                                               device, final_uniform=False)
        (self.mean_w,), (self.mean_b,) = _mlp_init(n_agents, [hidden[-1], act_dim],
                                                   generator, device)
        (self.log_std_w,), (self.log_std_b,) = _mlp_init(n_agents, [hidden[-1], act_dim],
                                                         generator, device)

    def forward(self, obs: torch.Tensor, agents: slice = slice(None)
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A, N, K) -> mean, log_std, each (A, N, M); ``agents`` picks a
        run of the stacked agents, whose inputs ``obs`` then holds."""
        x = obs
        for w, b in zip(self.trunk_w, self.trunk_b):
            x = torch.relu(_linear(x, w[agents], b[agents]))
        mean = _linear(x, self.mean_w[agents], self.mean_b[agents])
        log_std = torch.clamp(_linear(x, self.log_std_w[agents], self.log_std_b[agents]),
                              LOG_STD_MIN, LOG_STD_MAX)
        return mean, log_std

    def jax_paths(self) -> List[Tuple[tuple, nn.Parameter]]:
        n = len(self.trunk_w)
        return ([(("trunk", i, "w"), self.trunk_w[i]) for i in range(n)]
                + [(("trunk", i, "b"), self.trunk_b[i]) for i in range(n)]
                + [(("mean", "w"), self.mean_w), (("mean", "b"), self.mean_b),
                   (("log_std", "w"), self.log_std_w), (("log_std", "b"), self.log_std_b)])


def policy_sample(policy: Policy, obs: torch.Tensor, noise: torch.Tensor,
                  action_scale: torch.Tensor, action_bias: torch.Tensor,
                  act_mask: torch.Tensor = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Tanh-Gaussian sample with the bound-corrected log-prob
    (``rl.py:56-68``) from standard normal ``noise`` (A, N, M).
    ``action_scale``/``action_bias``/``act_mask`` are (A, M); padded
    action dims (mask 0) add nothing to the log-prob and act 0. Returns
    (action (A, N, M), log_prob (A, N, 1), deterministic action)."""
    scale, bias = action_scale[:, None], action_bias[:, None]
    mean, log_std = policy(obs)
    std = torch.exp(log_std)
    x_t = mean + std * noise
    y_t = torch.tanh(x_t)
    action = y_t * scale + bias
    log_prob = (-0.5 * ((x_t - mean) / std) ** 2 - log_std
                - HALF_LOG_2PI)
    log_prob = log_prob - torch.log(scale * (1 - y_t ** 2) + EPS)
    det_action = torch.tanh(mean) * scale + bias
    if act_mask is not None:
        mask = act_mask[:, None]
        log_prob, action, det_action = log_prob * mask, action * mask, det_action * mask
    return action, log_prob.sum(-1, keepdim=True), det_action


@dataclasses.dataclass
class AgentNets:
    """The twin Q networks, their targets, the policy and one Adam per
    trained network, all stacked over the agent axis."""
    q1: SoftQ
    q2: SoftQ
    q1_target: SoftQ
    q2_target: SoftQ
    policy: Policy
    q1_opt: torch.optim.Adam
    q2_opt: torch.optim.Adam
    policy_opt: torch.optim.Adam
    # sac_update's CUDA graph of these nets, not part of the state; a copy
    # or a pickle starts without one
    update_graph: Graph = dataclasses.field(default_factory=lambda: Graph("sac"), init=False,
                                            repr=False, compare=False)

    NETS = ("q1", "q2", "q1_target", "q2_target", "policy")
    OPTS = ("q1_opt", "q2_opt", "policy_opt")

    def state_dict(self) -> Dict[str, dict]:
        return {k: getattr(self, k).state_dict() for k in self.NETS + self.OPTS}

    def load_state_dict(self, state: Dict[str, dict]):
        """Copy ``state`` in. Adam's ``load_state_dict`` replaces the state
        tensors a captured update read, so the graph is dropped."""
        for k in self.NETS + self.OPTS:
            getattr(self, k).load_state_dict(state[k])
        for k in self.OPTS:
            _fit_adam(getattr(self, k))
        self.update_graph = Graph("sac")


def _adam(module: nn.Module, lr: float) -> torch.optim.Adam:
    """Adam as the JAX package's optax.adam; capturable (its step count on
    the device) when the module is on CUDA, for sac_update's graph."""
    params = list(module.parameters())
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                            capturable=params[0].is_cuda)


def _fit_adam(opt: torch.optim.Adam):
    """Make ``opt`` capturable exactly when its parameters are on CUDA, as
    :func:`_adam` builds it, with each ``step`` on the device that Adam
    reads it from. Adam's ``load_state_dict`` keeps the flag a state was
    saved with, which is wrong for a state saved on the other device."""
    for group in opt.param_groups:
        group["capturable"] = capturable = group["params"][0].is_cuda
        for p in group["params"]:
            state = opt.state.get(p, {})
            if "step" in state:
                state["step"] = state["step"].to(p.device if capturable else "cpu")


def make_agent_nets(n_agents: int, obs_dim: int, act_dim: int, hidden: Sequence[int],
                    lr: float, generator: torch.Generator, device=None) -> AgentNets:
    """Freshly initialised networks; the targets start as copies."""
    dev = resolve_device(device)
    q1 = SoftQ(n_agents, obs_dim, act_dim, hidden, generator, dev)
    q2 = SoftQ(n_agents, obs_dim, act_dim, hidden, generator, dev)
    policy = Policy(n_agents, obs_dim, act_dim, hidden, generator, dev)
    return AgentNets(q1=q1, q2=q2, q1_target=copy.deepcopy(q1),
                     q2_target=copy.deepcopy(q2), policy=policy,
                     q1_opt=_adam(q1, lr), q2_opt=_adam(q2, lr),
                     policy_opt=_adam(policy, lr))


def nets_from_numpy(tree, lr: float = 3e-4, device=None) -> AgentNets:
    """The port's :class:`AgentNets` from the JAX package's ``AgentNets``
    as numpy arrays (``jax.tree_util.tree_map(np.asarray, nets)``):
    weights, targets and the optax Adam state (``mu``/``nu``/``count``
    become ``exp_avg``/``exp_avg_sq``/``step``)."""
    dev = resolve_device(device)
    hidden = [int(np.shape(ln["scale"])[-1]) for ln in tree.q1["ln"]]
    n_agents, in_dim = np.shape(tree.q1["layers"][0]["w"])[:2]
    act_dim = int(np.shape(tree.policy["mean"]["w"])[-1])
    gen = torch.Generator(device=dev)
    nets = make_agent_nets(int(n_agents), int(in_dim) - act_dim, act_dim, hidden, lr,
                           gen, dev)

    def at(sub, path):
        for k in path:
            sub = sub[k]
        return torch.tensor(np.asarray(sub), device=dev)

    with torch.no_grad():
        for name in AgentNets.NETS:
            for path, p in getattr(nets, name).jax_paths():
                p.copy_(at(getattr(tree, name), path))
    for name in ("q1", "q2", "policy"):
        adam_state = getattr(tree, f"{name}_opt")[0]     # optax ScaleByAdamState
        opt = getattr(nets, f"{name}_opt")
        step = float(np.asarray(adam_state.count).reshape(-1)[0])
        for path, p in getattr(nets, name).jax_paths():
            opt.state[p] = {"step": torch.tensor(step, dtype=torch.float32),
                            "exp_avg": at(adam_state.mu, path),
                            "exp_avg_sq": at(adam_state.nu, path)}
        _fit_adam(opt)
    return nets


def huber_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``optax.huber_loss`` with delta 1, elementwise."""
    err = torch.abs(pred - target)
    quadratic = torch.clamp(err, max=1.0)
    return 0.5 * quadratic ** 2 + (err - quadratic)


def _adam_step(opt: torch.optim.Adam, params: List[nn.Parameter], grads):
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


LOSSES = ("q1", "q2", "policy")


def sac_update(nets: AgentNets, batch, noise: Tuple[torch.Tensor, torch.Tensor],
               action_scale: torch.Tensor, action_bias: torch.Tensor,
               act_mask: torch.Tensor, *, alpha: float, discount: float,
               tau: float) -> Dict[str, torch.Tensor]:
    """One SAC gradient step of every agent, in place (the per-agent
    update of ``citylearn_tpu/train.py:339-375`` over the stacked nets).

    ``batch`` = (obs (A, N, K), act (A, N, M), reward (A, N), next_obs
    (A, N, K), done (A, N)); ``noise`` = the standard normal draws (A, N,
    M) of the next-action sample and of the policy-loss sample. Each
    loss is a sum over agents of each agent's mean, so every agent's
    gradient is its own loss's. Returns the per-agent (A,) losses; each
    parameter's ``.grad`` holds the gradient applied.

    On CUDA inputs the update is a replay of the nets' CUDA graph of
    :func:`_sac_step` (``nets.update_graph``), bit-equal to running it,
    keyed also on alpha, discount, tau and the learning rates, and on
    ``action_scale``, ``action_bias`` and ``act_mask`` by identity. The
    gradients the capture set on the parameters are the graph's, so each
    ``.grad`` holds the gradient its replay applied. On any other device
    it runs :func:`_sac_step`."""
    hp = dict(alpha=alpha, discount=discount, tau=tau)
    if batch[0].device.type != "cuda":
        return _sac_step(nets, batch, noise, action_scale, action_bias, act_mask, **hp)
    consts, n = (action_scale, action_bias, act_mask), len(batch)

    def update(*inputs):
        with warnings.catch_warnings():
            # the graph's eager first update steps the capturable Adams
            # outside a capture
            warnings.filterwarnings("ignore", "This instance was constructed with capturable")
            losses = _sac_step(nets, inputs[:n], inputs[n:], *consts, **hp)
        return torch.stack([losses[k] for k in LOSSES])

    lrs = tuple(getattr(nets, k).param_groups[0]["lr"] for k in nets.OPTS)
    losses = nets.update_graph.run(update, (*batch, *noise), (alpha, discount, tau, lrs), consts)
    return dict(zip(LOSSES, losses.clone().unbind(0)))


def _sac_step(nets: AgentNets, batch, noise: Tuple[torch.Tensor, torch.Tensor],
              action_scale: torch.Tensor, action_bias: torch.Tensor,
              act_mask: torch.Tensor, *, alpha: float, discount: float,
              tau: float) -> Dict[str, torch.Tensor]:
    """:func:`sac_update`'s update, run eagerly."""
    o, a, r, n, d = batch
    noise_next, noise_pi = noise
    with tracing.span("sac.target"), torch.no_grad():
        next_a, next_log_pi, _ = policy_sample(nets.policy, n, noise_next,
                                               action_scale, action_bias, act_mask)
        tq = torch.minimum(*twin_q(nets.q1_target, nets.q2_target, n, next_a)) \
            - alpha * next_log_pi
        q_target = r[..., None] + (1 - d[..., None]) * discount * tq

    # both critics' losses before either Adam step: neither reads the other
    with tracing.span("sac.critic"):
        loss = [huber_loss(q, q_target).mean(dim=(1, 2)) for q in twin_q(nets.q1, nets.q2, o, a)]
        params = [list(nets.q1.parameters()), list(nets.q2.parameters())]
        grads = torch.autograd.grad(loss[0].sum() + loss[1].sum(), params[0] + params[1])
        _adam_step(nets.q1_opt, params[0], grads[:len(params[0])])
        _adam_step(nets.q2_opt, params[1], grads[len(params[0]):])
        losses = {"q1": loss[0].detach(), "q2": loss[1].detach()}

    # the policy loss reads the UPDATED Q nets; no gradient flows into them
    with tracing.span("sac.policy"):
        new_a, log_pi, _ = policy_sample(nets.policy, o, noise_pi, action_scale,
                                         action_bias, act_mask)
        q_new = torch.minimum(*twin_q(nets.q1, nets.q2, o, new_a, param_grads=False))
        loss = (alpha * log_pi - q_new).mean(dim=(1, 2))
        params = list(nets.policy.parameters())
        _adam_step(nets.policy_opt, params, torch.autograd.grad(loss.sum(), params))
        losses["policy"] = loss.detach()

    with tracing.span("sac.polyak"), torch.no_grad():
        for tgt, src in ((nets.q1_target, nets.q1), (nets.q2_target, nets.q2)):
            t, s = list(tgt.parameters()), list(src.parameters())
            torch._foreach_mul_(t, 1 - tau)
            torch._foreach_add_(t, torch._foreach_mul(s, tau))
    return losses


class ReplayBuffer:
    """Ring buffer of transitions (reference ``rl.py:75-93``)."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.buffer: list = []
        self.position = 0

    def push(self, state, action, reward, next_state, done):
        if len(self.buffer) < self.capacity:
            self.buffer.append(None)
        self.buffer[self.position] = (state, action, reward, next_state, done)
        self.position = (self.position + 1) % self.capacity

    def sample(self, batch_size, rng):
        idx = rng.choice(len(self.buffer), size=batch_size, replace=False)
        s, a, r, n, d = map(np.stack, zip(*[self.buffer[i] for i in idx]))
        return s, a, r, n, d

    def __len__(self):
        return len(self.buffer)


class PolicyNoise:
    """The host-loop SAC's standard normal policy noise, from one
    ``torch.Generator`` seeded by the agent's ``random_seed`` on its
    device. The JAX package splits a PRNG key per draw instead; a test
    swaps in an object with these two methods that returns its draws."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))

    def act(self, act_dim: int) -> torch.Tensor:
        """(1, 1, M): the noise of one action sample."""
        return torch.randn((1, 1, act_dim), generator=self.generator, device=self.device)

    def update(self, batch_size: int, act_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Two (1, N, M): the next-action and the policy-loss samples of an update."""
        return tuple(torch.randn((1, batch_size, act_dim), generator=self.generator,
                                 device=self.device) for _ in range(2))


class SAC(RLC):
    """Per-building soft actor-critic agents stepping the env from the
    host (reference ``citylearn/agents/sac.py``): twin soft-Q networks
    with LayerNorm, a tanh-Gaussian policy, replay standardization from
    ``standardize_start_time_step`` and ``action_scaling_coefficient``-scaled
    uniform exploration until ``end_exploration_time_step``.

    Exploration actions and replay batches come from ``self._np_random``
    (``np.random.RandomState(random_seed)``) as in the JAX package, so both
    draw the same; the policy noise comes from :class:`PolicyNoise`."""

    def __init__(self, env, **kwargs: Any):
        super().__init__(env, **kwargs)
        n = len(self.action_space)
        self.time_step = 0
        self.normalized = [False] * n
        self.replay_buffer = [ReplayBuffer(self.replay_buffer_capacity) for _ in range(n)]
        self.norm_mean = [None] * n
        self.norm_std = [None] * n
        self.r_norm_mean = [None] * n
        self.r_norm_std = [None] * n
        self.device = env.device
        self.noise = PolicyNoise(self.random_seed, self.device)
        self.nets: List[AgentNets] = []
        self.action_scale: List[torch.Tensor] = []
        self.action_bias: List[torch.Tensor] = []
        self.set_networks()

    def set_encoders(self):
        encoders = super().set_encoders()
        for i, names in enumerate(self.observation_names):
            for j, n in enumerate(names):
                if n == "net_electricity_consumption":
                    encoders[i][j] = RemoveFeature()
        return encoders

    def set_networks(self, internal_observation_count: int = 0):
        """One network set per agent, initialised from the noise's generator."""
        self.nets, self.action_scale, self.action_bias = [], [], []
        for i, space in enumerate(self.action_space):
            obs_dim = self.observation_dimension[i] + internal_observation_count
            self.nets.append(make_agent_nets(1, obs_dim, space.shape[0], self.hidden_dimension,
                                             self.lr, self.noise.generator, self.device))
            coef = self.action_scaling_coefficient
            scale = coef * (space.high - space.low) / 2.0
            bias = coef * (space.high + space.low) / 2.0
            self.action_scale.append(torch.tensor(np.asarray(scale, np.float32)[None],
                                                  device=self.device))
            self.action_bias.append(torch.tensor(np.asarray(bias, np.float32)[None],
                                                 device=self.device))

    # ------------------------------------------------------------------
    def update(self, observations, actions, reward, next_observations,
               terminated: bool, truncated: bool):
        """Reference ``sac.py:56-165``."""
        for i, (o, a, r, n) in enumerate(zip(observations, actions, reward,
                                             next_observations)):
            o = encode(self.encoders[i], o)
            n = encode(self.encoders[i], n)
            if self.normalized[i]:
                o = self._norm_obs(i, o)
                n = self._norm_obs(i, n)
                r = self._norm_reward(i, r)
            self.replay_buffer[i].push(o, np.asarray(a, float), r, n, float(terminated))

            if self.time_step >= self.standardize_start_time_step \
                    and self.batch_size <= len(self.replay_buffer[i]):
                if not self.normalized[i]:
                    buf = self.replay_buffer[i].buffer
                    X = np.array([j[0] for j in buf], dtype=float)
                    self.norm_mean[i] = np.nanmean(X, axis=0)
                    self.norm_std[i] = np.nanstd(X, axis=0) + 1e-5
                    R = np.array([j[2] for j in buf], dtype=float)
                    self.r_norm_mean[i] = float(np.nanmean(R))
                    self.r_norm_std[i] = float(np.nanstd(R)) / self.reward_scaling + 1e-5
                    self.replay_buffer[i].buffer = [
                        (self._norm_obs(i, o_), a_, self._norm_reward(i, r_),
                         self._norm_obs(i, n_), d_)
                        for o_, a_, r_, n_, d_ in buf]
                    self.normalized[i] = True
                self._train_agent(i)
        self.time_step += 1

    def _train_agent(self, i: int):
        """``update_per_time_step`` SAC updates of agent ``i`` on batches
        drawn from its replay ring."""
        for _ in range(self.update_per_time_step):
            batch = self.replay_buffer[i].sample(self.batch_size, self._np_random)
            batch = tuple(torch.tensor(np.asarray(x, np.float32), device=self.device)[None]
                          for x in batch)
            noise = self.noise.update(self.batch_size, self.action_space[i].shape[0])
            sac_update(self.nets[i], batch, noise, self.action_scale[i], self.action_bias[i],
                       None, alpha=self.alpha, discount=self.discount, tau=self.tau)

    def predict(self, observations, deterministic: bool = None):
        deterministic = bool(deterministic)
        if self.time_step > self.end_exploration_time_step or deterministic:
            return self.get_post_exploration_prediction(observations, deterministic)
        return self.get_exploration_prediction(observations)

    def _sample_policy(self, net_index: int, i: int, obs_vec, deterministic: bool) -> list:
        """One action of agent ``i`` from the policy of ``nets[net_index]``
        on one encoded observation; the noise is drawn either way."""
        noise = self.noise.act(self.action_space[i].shape[0])
        obs = torch.tensor(np.asarray(obs_vec, np.float32), device=self.device)[None, None]
        with torch.no_grad():
            a, _, det = policy_sample(self.nets[net_index].policy, obs, noise,
                                      self.action_scale[i], self.action_bias[i])
        return list((det if deterministic else a)[0, 0].cpu().numpy())

    def get_post_exploration_prediction(self, observations, deterministic):
        actions = []
        for i, o in enumerate(observations):
            o = self._norm_obs(i, encode(self.encoders[i], o))
            actions.append(self._sample_policy(i, i, o, deterministic))
        return actions

    def get_exploration_prediction(self, observations):
        """``action_scaling_coefficient``-scaled random actions (sac.py:219-223)."""
        return [list(self.action_scaling_coefficient * self._np_random.uniform(s.low, s.high))
                for s in self.action_space]

    def _norm_obs(self, i, o):
        if self.norm_mean[i] is None:
            return np.asarray(o, float)
        return (np.asarray(o, float) - self.norm_mean[i]) / self.norm_std[i]

    def _norm_reward(self, i, r):
        if self.r_norm_mean[i] is None:
            return r
        return (r - self.r_norm_mean[i]) / self.r_norm_std[i]

    def reset(self):
        super().reset()
        self.time_step = 0


class SACRBC(SAC):
    """SAC with RBC-guided exploration (reference ``sac.py:273-317``)."""

    def __init__(self, env, rbc: Union[RBC, str, type] = None, **kwargs: Any):
        super().__init__(env, **kwargs)
        if rbc is None:
            rbc = BasicRBC(env)
        elif isinstance(rbc, type):
            rbc = rbc(env)
        self.rbc = rbc

    def get_exploration_prediction(self, observations):
        return self.rbc.predict(observations)
