"""Faults of the per-step EV cell planted in the program underneath a run,
which must make ``correct`` come out false (beside :mod:`benchmark.faults`'
``frozen_update``, ``half_batch`` and ``stale_reset`` and
:mod:`benchmark.faults_scan`'s ``altered_action``, which the cell shares
with the others). Each patches the trainer module's ``district_step`` in
the process that runs it, so that the step reads altered parameters or an
altered configuration."""

import dataclasses

import torch


def _altered_params(alter, alter_cfg=lambda cfg: cfg):
    import citylearn_tpu_torch.train as train_mod

    shipped = train_mod.district_step

    def step(cfg, params, state, actions):
        return shipped(alter_cfg(cfg), alter(params), state, actions)

    train_mod.district_step = step


def scalar_efficiency():
    """Every charger's charge and discharge efficiency curves read as its
    scalar efficiency."""
    def alter(params):
        ch = params.chargers
        flat = lambda y: ch.efficiency[:, None].expand_as(y).contiguous()
        return dataclasses.replace(params, chargers=dataclasses.replace(
            ch, charge_eff_y=flat(ch.charge_eff_y), discharge_eff_y=flat(ch.discharge_eff_y)))

    _altered_params(alter)


def arrival_unforced():
    """No EV's state of charge is set when it arrives (or is announced):
    it carries on from where it was."""
    def alter(params):
        evs = params.evs
        return dataclasses.replace(params, evs=dataclasses.replace(
            evs, force_soc=torch.full_like(evs.force_soc, float("nan"))))

    _altered_params(alter)


def machine_unloaded():
    """The washing machines' load is dropped: a started machine consumes
    nothing."""
    def alter(params):
        wm = params.washing_machines
        return dataclasses.replace(params, washing_machines=dataclasses.replace(
            wm, triggered_load=torch.zeros_like(wm.triggered_load)))

    _altered_params(alter)


def close_soc_dropped():
    """The EV reward's close-SOC terms weighed 0 (``close_soc``, the fifth
    of the reward's weights): the reward alone is wrong."""
    def alter_cfg(cfg):
        w = cfg.ev_reward_weights
        return dataclasses.replace(cfg, ev_reward_weights=w[:4] + (0.0,) + w[5:])

    _altered_params(lambda params: params, alter_cfg)
