"""Faults planted in the program underneath a run, which must make
``correct`` come out false: the benchmark's tests plant them at a small
size on the CPU. Each patches the program's module or class attributes in
the process that runs it."""

import torch


def frozen_update():
    """Every SAC update leaves the networks as they were."""
    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.sac_update

    def frozen(nets, *args, **kw):
        saved = {k: [p.detach().clone() for p in getattr(nets, k).parameters()] for k in nets.NETS}
        out = shipped(nets, *args, **kw)
        with torch.no_grad():
            for k, ps in saved.items():
                for p, old in zip(getattr(nets, k).parameters(), ps):
                    p.copy_(old)
        return out

    train_mod.sac_update = frozen


def half_batch():
    """Every update leaves out half of its batch, the mean taken over the rest."""
    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.sac_update

    def half(nets, batch, noise, *args, **kw):
        n = batch[0].shape[1] // 2
        return shipped(nets, tuple(x[:, :n] for x in batch), tuple(x[:, :n] for x in noise),
                       *args, **kw)

    train_mod.sac_update = half


def altered_reward():
    """K2's reward of district 0, building 0 negated where it is made."""
    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.battery_collect_chunk

    def altered(*args, **kw):
        reward, *state = shipped(*args, **kw)
        reward = reward.clone()
        reward[:, 0, 0] = -reward[:, 0, 0]
        return (reward, *state)

    train_mod.battery_collect_chunk = altered


def stale_reset():
    """The episode's reset restores a wrong battery state (the state of
    charge at one half)."""
    import dataclasses

    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.BatchedSAC._broadcast_initial

    def stale(self, offsets):
        st = shipped(self, offsets)
        return dataclasses.replace(st, battery_soc=torch.full_like(st.battery_soc, 0.5))

    train_mod.BatchedSAC._broadcast_initial = stale


def frozen_env_step():
    """The env's district step returns the state it was given."""
    from citylearn_tpu_torch.envs import environment as env_mod

    shipped = env_mod.step_packed
    env_mod.step_packed = lambda cfg, params, state, acts: (state, shipped(cfg, params, state, acts)[1])


def altered_env_reward():
    """Building 0's reward negated in the step's packed output."""
    from citylearn_tpu_torch.envs import environment as env_mod

    shipped = env_mod.step_packed

    def altered(cfg, params, state, acts):
        st, flat = shipped(cfg, params, state, acts)
        flat = flat.clone()
        at = len(env_mod._HIST_FIELDS) * cfg.n_buildings
        flat[at] = -flat[at]
        return st, flat

    env_mod.step_packed = altered
