"""The port's SAC networks and update (``citylearn_tpu_torch.agents.sac``)
against the JAX package's: weights carried across with
``nets_from_numpy``, Gaussian noise drawn by ``jax.random.normal`` here
and fed to the port.

Tolerances. Network outputs, losses and gradients: 1e-5 relative to
each output's scale — the port's batched matrix products sum in another
order than XLA:CPU's, which also fuses multiply-adds. Updated weights,
targets and Adam moments: 1e-6 absolute — torch's Adam rounds its
bias corrections and moment updates in another order than optax
(``lerp`` and ``sqrt(nu) / sqrt(1 - b2^t)`` against ``sqrt(nu / (1 -
b2^t))``), a difference far below the size of one update."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from citylearn_tpu.agents.sac import AgentNets as JaxAgentNets
from citylearn_tpu.agents.sac import _policy_forward, _policy_init, _policy_sample
from citylearn_tpu.agents.sac import _q_apply, _q_init
from citylearn_tpu.train import BatchedSAC as JaxBatchedSAC
from citylearn_tpu.train import TrainConfig as JaxTrainConfig
from citylearn_tpu_torch.agents import sac

A, K, M, N = 3, 7, 2, 32
HIDDEN = (16, 16)
CFG = JaxTrainConfig(hidden=HIDDEN, batch_size=N)
# agent 1 has one real action and one padded slot (mask 0, scale 0)
MASK = np.array([[1, 1], [1, 0], [1, 1]], np.float32)
LOW = np.array([[-1, -0.5], [-1, 0], [-0.8, -1]], np.float32) * MASK
HIGH = np.array([[1, 0.5], [1, 0], [0.6, 1]], np.float32) * MASK
SCALE, BIAS = (HIGH - LOW) / 2, (HIGH + LOW) / 2


def assert_close(ours, ref, name, rtol=1e-5):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * scale, err_msg=name)


def at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def jax_nets(seed=0):
    """Stacked JAX AgentNets as ``BatchedSAC._init_state`` builds them."""
    opt = optax.adam(CFG.lr)
    ks = jax.random.split(jax.random.PRNGKey(seed), 3 * A)
    stack = lambda ts: jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ts)
    q1 = stack([_q_init(ks[3 * i], K, M, list(HIDDEN)) for i in range(A)])
    q2 = stack([_q_init(ks[3 * i + 1], K, M, list(HIDDEN)) for i in range(A)])
    pi = stack([_policy_init(ks[3 * i + 2], K, M, list(HIDDEN)) for i in range(A)])
    return JaxAgentNets(q1=q1, q2=q2, q1_target=jax.tree_util.tree_map(jnp.array, q1),
                        q2_target=jax.tree_util.tree_map(jnp.array, q2), policy=pi,
                        q1_opt=jax.vmap(opt.init)(q1), q2_opt=jax.vmap(opt.init)(q2),
                        policy_opt=jax.vmap(opt.init)(pi))


def carried(nets):
    return sac.nets_from_numpy(jax.tree_util.tree_map(np.asarray, nets), lr=CFG.lr,
                               device="cpu")


def agent_noise(keys, shape):
    """The draws of ``_policy_sample(..., key)`` for each agent's key,
    stacked (A, N, M)."""
    return torch.tensor(np.stack([np.asarray(jax.random.normal(k, shape)) for k in keys]))


def test_networks_match_jax():
    nets = jax_nets()
    ours = carried(nets)
    rng = np.random.RandomState(0)
    obs = rng.uniform(-1, 1, (A, N, K)).astype(np.float32)
    act = rng.uniform(-1, 1, (A, N, M)).astype(np.float32)
    t = torch.tensor
    with torch.no_grad():
        assert_close(ours.q1(t(obs), t(act)), jax.vmap(_q_apply)(nets.q1, obs, act), "q1")
        assert_close(ours.q2_target(t(obs), t(act)),
                     jax.vmap(_q_apply)(nets.q2_target, obs, act), "q2_target")
        mean, log_std = ours.policy(t(obs))
        jmean, jlog_std = jax.vmap(_policy_forward)(nets.policy, obs)
        assert_close(mean, jmean, "mean")
        assert_close(log_std, jlog_std, "log_std")

        keys = jax.random.split(jax.random.PRNGKey(5), A)
        ref = jax.vmap(_policy_sample)(nets.policy, obs, keys, SCALE, BIAS, MASK)
        got = sac.policy_sample(ours.policy, t(obs), agent_noise(keys, (N, M)),
                                t(SCALE), t(BIAS), t(MASK))
    for name, a, b in zip(("action", "log_prob", "det_action"), got, ref):
        assert_close(a, b, name)
    assert got[1].shape == (A, N, 1)
    assert torch.all(got[0][1, :, 1] == 0)          # the padded slot acts 0


def test_huber_matches_optax():
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_array_equal(sac.huber_loss(torch.tensor(x), torch.zeros(61)).numpy(),
                                  np.asarray(optax.huber_loss(x, np.zeros(61), delta=1.0)))


@jax.jit
def jax_grads(nets, new_nets, batch, keys):
    """Per-agent losses and gradients of the JAX update, compiled as the
    trainer compiles it: the Q losses at the old Q nets, the policy loss
    at the UPDATED ones."""

    def one(nets_i, new_i, o, a, r, n, d, key, scale, bias, mask):
        k1, k2 = jax.random.split(key)
        na, nlp, _ = _policy_sample(nets_i.policy, n, k1, scale, bias, mask)
        tq = jnp.minimum(_q_apply(nets_i.q1_target, n, na),
                         _q_apply(nets_i.q2_target, n, na)) - CFG.alpha * nlp
        qt = jax.lax.stop_gradient(r[:, None] + (1 - d[:, None]) * CFG.discount * tq)
        q_loss = lambda qp: optax.huber_loss(_q_apply(qp, o, a), qt).mean()

        def pi_loss(pp):
            a2, lp, _ = _policy_sample(pp, o, k2, scale, bias, mask)
            q = jnp.minimum(_q_apply(new_i.q1, o, a2), _q_apply(new_i.q2, o, a2))
            return (CFG.alpha * lp - q).mean()

        return (jax.value_and_grad(q_loss)(nets_i.q1), jax.value_and_grad(q_loss)(nets_i.q2),
                jax.value_and_grad(pi_loss)(nets_i.policy))

    o, a, r, n, d = batch
    return jax.vmap(one, in_axes=(0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0))(
        nets, new_nets, o, a, r, n, d, keys, SCALE, BIAS, MASK)


def test_update_matches_jax():
    """Two consecutive updates of all agents: the JAX ``_make_update_agent``
    under ``vmap`` and the port's ``sac_update`` on the same batches and
    noise. The second update starts from non-zero Adam moments."""
    trainer = types.SimpleNamespace(cfg=CFG, optimizer=optax.adam(CFG.lr))
    vupdate = jax.jit(jax.vmap(JaxBatchedSAC._make_update_agent(trainer),
                               in_axes=(0, 1, 0, 0, 0, 0)))
    nets = jax_nets(seed=1)
    ours = carried(nets)
    rng = np.random.RandomState(2)
    t = torch.tensor
    for it in range(2):
        # JAX batch layout (N, A, ...): the trainer's vmap maps axis 1
        batch = (rng.uniform(-1, 1, (N, A, K)).astype(np.float32),
                 (rng.uniform(-1, 1, (N, A, M)) * MASK).astype(np.float32),
                 rng.uniform(-3, 0, (N, A)).astype(np.float32),
                 rng.uniform(-1, 1, (N, A, K)).astype(np.float32),
                 (rng.uniform(0, 1, (N, A)) < 0.2).astype(np.float32))
        keys = jax.random.split(jax.random.PRNGKey(10 + it), A)
        new = vupdate(nets, batch, keys, SCALE, BIAS, MASK)
        (l1, g1), (l2, g2), (lp, gp) = jax_grads(nets, new, batch, keys)

        split = [jax.random.split(k) for k in keys]
        noise = (agent_noise([s[0] for s in split], (N, M)),
                 agent_noise([s[1] for s in split], (N, M)))
        first = lambda x: t(np.swapaxes(x, 0, 1).copy())
        losses = sac.sac_update(ours, tuple(first(x) for x in batch), noise, t(SCALE), t(BIAS),
                                t(MASK), alpha=CFG.alpha, discount=CFG.discount, tau=CFG.tau)
        for name, loss in (("q1", l1), ("q2", l2), ("policy", lp)):
            assert_close(losses[name], loss, f"{name} loss, update {it}")
        for name, grads in (("q1", g1), ("q2", g2), ("policy", gp)):
            for path, p in getattr(ours, name).jax_paths():
                assert_close(p.grad, at(grads, path), f"{name} grad {path}, update {it}")
        for name in sac.AgentNets.NETS:
            for path, p in getattr(ours, name).jax_paths():
                np.testing.assert_allclose(p.detach().numpy(), at(getattr(new, name), path),
                                           rtol=0, atol=1e-6, err_msg=f"{name} {path}")
        for name in ("q1", "q2", "policy"):
            adam = getattr(new, f"{name}_opt")[0]
            opt = getattr(ours, f"{name}_opt")
            for path, p in getattr(ours, name).jax_paths():
                state = opt.state[p]
                assert float(state["step"]) == float(np.asarray(adam.count)[0]) == it + 1
                for ours_k, ref in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                    np.testing.assert_allclose(state[ours_k].numpy(), at(ref, path), rtol=0,
                                               atol=1e-6, err_msg=f"{name} {ours_k} {path}")
        nets = new
    # the targets moved by Polyak averaging, not by gradients
    assert ours.q1_target.w[0].grad is None


def test_fresh_nets():
    gen = torch.Generator().manual_seed(0)
    nets = sac.make_agent_nets(A, K, M, HIDDEN, 3e-4, gen, device="cpu")
    assert nets.q1.w[0].shape == (A, K + M, HIDDEN[0])
    assert float(nets.q1.w[-1].detach().abs().max()) <= 3e-3       # the uniform head
    assert float(nets.policy.trunk_w[0].detach().abs().max()) <= 1 / np.sqrt(K)
    for path, p in nets.q1.jax_paths():
        assert torch.equal(p, dict(nets.q1_target.jax_paths())[path]), path
    assert not torch.equal(nets.q1.w[0], nets.q2.w[0])
