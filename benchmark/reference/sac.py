"""Soft actor-critic for A agents side by side (CityLearn's ``rl.py`` and
``agents/sac.py``): twin soft-Q networks with LayerNorm, a tanh-Gaussian
policy, a Huber critic loss, Polyak targets and ``torch.optim.Adam`` at
optax's settings (betas 0.9 and 0.999, eps 1e-8).

Parameters are dicts of named leaves, each with a leading agent axis, under
the names the program's modules give them (``w.0``, ``trunk_w.1``, ...),
so that the benchmark can load one set of seeded weights into both. Every
matrix product goes through ``matmul``, which the control swaps for one
that rounds its operands to TF32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
EPS = 1e-6
HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8

Params = Dict[str, torch.Tensor]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32's 10 mantissa bits, to nearest with ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """A matrix product on operands rounded to TF32, with float32
    accumulation, forward and backward: what a tensor core's TF32 mode
    computes."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(_round_tf32(a), _round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return (torch.matmul(g, _round_tf32(b).transpose(-1, -2)),
                torch.matmul(_round_tf32(a).transpose(-1, -2), g))


MATMULS: Dict[str, Callable] = {"fp32": torch.matmul, "tf32": _TF32MatMul.apply}


def layer_sizes(obs_dim: int, act_dim: int, hidden: Sequence[int]):
    """(name, shape-without-agent-axis, init bound) of every leaf, in the
    order the benchmark draws them: q1, q2, policy."""
    q_sizes = [obs_dim + act_dim, *hidden, 1]
    leaves = []
    for net in ("q1", "q2"):
        for i, (fi, fo) in enumerate(zip(q_sizes[:-1], q_sizes[1:])):
            bound = 3e-3 if i == len(q_sizes) - 2 else 1.0 / math.sqrt(fi)
            leaves += [(net, f"w.{i}", (fi, fo), bound), (net, f"b.{i}", (fo,), bound)]
        for i, h in enumerate(hidden):
            leaves += [(net, f"ln_scale.{i}", (h,), None), (net, f"ln_bias.{i}", (h,), None)]
    p_sizes = [obs_dim, *hidden]
    for i, (fi, fo) in enumerate(zip(p_sizes[:-1], p_sizes[1:])):
        bound = 1.0 / math.sqrt(fi)
        leaves += [("policy", f"trunk_w.{i}", (fi, fo), bound), ("policy", f"trunk_b.{i}", (fo,), bound)]
    for head in ("mean", "log_std"):
        leaves += [("policy", f"{head}_w", (hidden[-1], act_dim), 3e-3),
                   ("policy", f"{head}_b", (act_dim,), 3e-3)]
    return leaves


def init_params(n_agents: int, obs_dim: int, act_dim: int, hidden: Sequence[int],
                generator: torch.Generator, device) -> Dict[str, Params]:
    """Seeded weights of q1, q2 and the policy in one uniform draw: weights
    and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the last layers
    U(-3e-3, 3e-3); LayerNorm scales 1 and biases 0."""
    leaves = layer_sizes(obs_dim, act_dim, hidden)
    drawn = [(n_agents,) + shape for _, _, shape, bound in leaves if bound is not None]
    u = torch.rand(sum(math.prod(s) for s in drawn), generator=generator, device=device)
    nets: Dict[str, Params] = {"q1": {}, "q2": {}, "policy": {}}
    offset = 0
    for net, name, shape, bound in leaves:
        full = (n_agents,) + shape
        if bound is None:
            fill = 1.0 if name.startswith("ln_scale") else 0.0
            nets[net][name] = torch.full(full, fill, device=device)
            continue
        n = math.prod(full)
        nets[net][name] = u[offset:offset + n].view(full) * (2.0 * bound) - bound
        offset += n
    return nets


def _linear(x, w, b, mm):
    return mm(x, w) + b[:, None, :]


def q_value(p: Params, obs, act, mm) -> torch.Tensor:
    """(A, N, K), (A, N, M) -> (A, N, 1)."""
    n_hidden = sum(1 for k in p if k.startswith("ln_scale"))
    x = torch.cat([obs, act], -1)
    for i in range(n_hidden):
        x = torch.relu(_linear(x, p[f"w.{i}"], p[f"b.{i}"], mm))
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + 1e-5) * p[f"ln_scale.{i}"][:, None] \
            + p[f"ln_bias.{i}"][:, None]
    return _linear(x, p[f"w.{n_hidden}"], p[f"b.{n_hidden}"], mm)


def sample(p: Params, obs, noise, scale, bias, mm):
    """Tanh-Gaussian action (A, N, M), its log-probability (A, N, 1) with
    the squashing correction, and the deterministic action."""
    n_hidden = sum(1 for k in p if k.startswith("trunk_w"))
    x = obs
    for i in range(n_hidden):
        x = torch.relu(_linear(x, p[f"trunk_w.{i}"], p[f"trunk_b.{i}"], mm))
    mean = _linear(x, p["mean_w"], p["mean_b"], mm)
    log_std = torch.clamp(_linear(x, p["log_std_w"], p["log_std_b"], mm), LOG_STD_MIN, LOG_STD_MAX)
    std = torch.exp(log_std)
    u = mean + std * noise
    y = torch.tanh(u)
    scale, bias = scale[:, None], bias[:, None]
    log_prob = -0.5 * ((u - mean) / std) ** 2 - log_std - HALF_LOG_2PI \
        - torch.log(scale * (1 - y ** 2) + EPS)
    return y * scale + bias, log_prob.sum(-1, keepdim=True), torch.tanh(mean) * scale + bias


def act(p: Params, obs, noise, scale, bias, mm) -> torch.Tensor:
    """The sampled actions (A, N, M) of the policy ``p``, without gradients."""
    with torch.no_grad():
        return sample(p, obs, noise, scale, bias, mm)[0]


def huber(pred, target):
    err = torch.abs(pred - target)
    small = torch.clamp(err, max=1.0)
    return 0.5 * small ** 2 + (err - small)


class Agents:
    """The networks, targets and optimizers of A agents."""

    def __init__(self, nets: Dict[str, Params], lr: float, mm):
        leaves = lambda net: {k: v.detach().clone().requires_grad_(True) for k, v in net.items()}
        self.q1, self.q2, self.policy = leaves(nets["q1"]), leaves(nets["q2"]), leaves(nets["policy"])
        self.q1_target = {k: v.detach().clone() for k, v in nets["q1"].items()}
        self.q2_target = {k: v.detach().clone() for k, v in nets["q2"].items()}
        self.opt = {n: torch.optim.Adam(list(getattr(self, n).values()), lr=lr,
                                        betas=(BETA1, BETA2), eps=ADAM_EPS)
                    for n in ("q1", "q2", "policy")}
        self.mm = mm
        self.first_grads: Dict[str, Params] = {}

    def trained(self) -> Dict[str, Params]:
        return {n: {k: v.detach() for k, v in getattr(self, n).items()}
                for n in ("q1", "q2", "policy")}

    def update(self, batch, noise: Tuple[torch.Tensor, torch.Tensor], scale, bias, *,
               alpha: float, discount: float, tau: float, fault: str = None) -> Dict[str, torch.Tensor]:
        """One update of every agent on ``batch`` = (obs (A, N, K), act
        (A, N, M), reward (A, N), next obs (A, N, K), done (A, N)). Returns
        the per-agent losses (A,). ``fault`` plants one of the faults the
        benchmark's control holds the comparison against."""
        mm = self.mm
        o, a, r, n, d = batch
        noise_next, noise_pi = noise
        if fault == "half_batch":
            half = o.shape[1] // 2
            o, a, r, n, d = (x[:, :half] for x in (o, a, r, n, d))
            noise_next, noise_pi = noise_next[:, :half], noise_pi[:, :half]
        with torch.no_grad():
            next_a, next_logp, _ = sample(self.policy, n, noise_next, scale, bias, mm)
            target_q = torch.minimum(q_value(self.q1_target, n, next_a, mm),
                                     q_value(self.q2_target, n, next_a, mm)) - alpha * next_logp
            y = r[..., None] + (1 - d[..., None]) * discount * target_q
        losses = {}
        for name in ("q1", "q2"):
            p = getattr(self, name)
            loss = huber(q_value(p, o, a, mm), y).mean(dim=(1, 2))
            self._step(name, torch.autograd.grad(loss.sum(), list(p.values())), fault)
            losses[name] = loss.detach()
        p = self.policy
        new_a, logp, _ = sample(p, o, noise_pi, scale, bias, mm)
        q1, q2 = ({k: v.detach() for k, v in q.items()} for q in (self.q1, self.q2))
        q_new = torch.minimum(q_value(q1, o, new_a, mm), q_value(q2, o, new_a, mm))
        loss = (alpha * logp - q_new).mean(dim=(1, 2))
        self._step("policy", torch.autograd.grad(loss.sum(), list(p.values())), fault)
        losses["policy"] = loss.detach()
        with torch.no_grad():
            for tgt, src in ((self.q1_target, self.q1), (self.q2_target, self.q2)):
                for k in tgt:
                    tgt[k] = tgt[k] * (1 - tau) + src[k] * tau
        return losses

    def _step(self, name: str, grads, fault: str):
        params = getattr(self, name)
        self.first_grads.setdefault(name, {k: g.clone() for k, g in zip(params, grads)})
        if fault == "frozen_state":
            return
        for p, g in zip(params.values(), grads):
            p.grad = g
        self.opt[name].step()
