"""Faults of the per-step LSTM cell planted in the program underneath a
run, which must make ``correct`` come out false (beside
:mod:`benchmark.faults`' ``frozen_update``, ``half_batch`` and
``stale_reset``, which the cell shares with the chunked one). Each patches
a module attribute of the program in the process that runs it."""

import torch


def altered_action():
    """District 0, building 0's battery action reversed where the district
    step takes it (the replay keeps the action as it was drawn)."""
    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.district_step

    def altered(cfg, params, state, actions):
        actions = dict(actions)
        a = actions["electrical_storage"].clone()
        a[0, 0] = -a[0, 0]
        actions["electrical_storage"] = a
        return shipped(cfg, params, state, actions)

    train_mod.district_step = altered


def lstm_uncarried():
    """The LSTM starts every step from a zero hidden state instead of the
    one carried from the step before."""
    import citylearn_tpu_torch.core.step as step_mod

    shipped = step_mod.dynamics_update

    def uncarried(cfg, params, tau, t, cooling, heating, temp, lstm_h, lstm_c, window):
        zeros = lambda xs: tuple(torch.zeros_like(x) for x in xs)
        return shipped(cfg, params, tau, t, cooling, heating, temp, zeros(lstm_h),
                       zeros(lstm_c), window)

    step_mod.dynamics_update = uncarried
