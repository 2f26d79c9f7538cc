"""Batched MARLISA: the reference's sequential information-sharing
coordination ring (``citylearn/agents/marlisa.py:298-331``) over a batch
of district copies, on top of :class:`citylearn_tpu_torch.train.BatchedSAC`.

The port of ``citylearn_tpu/train_marlisa.py``. Each agent's policy
input is its encoded observation plus two coordination variables: the
district's expected total demand so far in the ring, and the share of
dispatch capacity of the agents before it. The ring runs ``iterations``
sweeps over the agents in order, a plain loop over (sweep, agent), each
step one agent's policy on all D districts at once. Differences from the
reference, as in the JAX package:

- **The regression is a streaming ridge.** Per-agent normal equations
  (X^T X, X^T y) accumulate every step from all districts and are solved
  every ``regression_update_every`` steps, where the reference refits a
  scikit-learn ``LinearRegression`` on a growing buffer. The solve runs in
  float64 (:func:`ridge_solve`), where the JAX package's runs in float32.
- **The regression target is the step's true net consumption**
  (``StepOutput.net_electricity_consumption``). The reference regresses
  on the returned observation's value, which its unwritten-index quirk
  pins to 0 after every reset, so its estimator predicts zero.
- **No PCA rotation** (the reference's default ``pca_compression = 1.0``
  is an invertible rotation); the encoder-normalized observations feed
  the policy directly.
- **Exploration-phase coordination variables are zero.**

Transitions are stored delayed by one step, so that the stored next
observation carries the coordination variables its action saw; a
transition that crosses an episode reset is dropped. Every step runs the
per-step collect: the coordination observations keep the chunked kernel
collect K2 off.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from citylearn_tpu_torch import resolve_device
from citylearn_tpu_torch.agents.sac import policy_sample
from citylearn_tpu_torch.core.evaluate import evaluate_districts
from citylearn_tpu_torch.core.step import district_step
from citylearn_tpu_torch.train import (
    BatchedSAC,
    StepDraws,
    TrainConfig,
    TrainState,
    train_state_from_numpy,
)

COORD_VARS = 2
RIDGE = 1e-3


@dataclasses.dataclass
class MarlisaTrainState:
    base: TrainState
    cv: torch.Tensor             # (D, A, 2) coordination variables of the last step
    reg_xtx: torch.Tensor        # (A, F, F) streaming normal equations
    reg_xty: torch.Tensor        # (A, F)
    reg_w: torch.Tensor          # (A, F) solved ridge weights
    # the previous step's transition, stored once its next observation
    # (with the coordination variables its action saw) is known
    prev_obs: torch.Tensor       # (D, A, K) with the coordination dims
    prev_act: torch.Tensor       # (D, A, M)
    prev_rew: torch.Tensor       # (D, A)
    prev_valid: bool             # False at the start and after a reset

    TENSORS = ("cv", "reg_xtx", "reg_xty", "reg_w", "prev_obs", "prev_act", "prev_rew")


def ridge_solve(xtx: torch.Tensor, xty: torch.Tensor) -> torch.Tensor:
    """Per-agent ridge weights (A, F) from the float32 normal equations
    (A, F, F) and (A, F), solved in float64 and rounded to float32.

    In float32 the ridge is lost: once the accumulators hold ~16k rows, 1e-3
    is below half an ulp of X^T X's diagonal, and the encoder's collinear
    columns (a one-hot class that every row so far shares, beside the
    constant) make ``X^T X + 1e-3 I`` exactly singular. The JAX package's
    float32 ``jnp.linalg.solve`` returns whatever its pivots give there;
    ``torch.linalg.solve`` raises on the card. In float64 the same
    accumulators plus the ridge are positive definite."""
    eye = torch.eye(xtx.shape[-1], dtype=torch.float64, device=xtx.device)
    return torch.linalg.solve(xtx.double() + RIDGE * eye, xty.double()).float()


def marlisa_state_from_numpy(tree, lr: float = 3e-4, device=None) -> MarlisaTrainState:
    """The port's :class:`MarlisaTrainState` from the JAX package's as
    numpy arrays (``jax.tree_util.tree_map(np.asarray, trainer.state)``),
    its ``base`` through :func:`citylearn_tpu_torch.train.train_state_from_numpy`."""
    dev = resolve_device(device)
    return MarlisaTrainState(
        base=train_state_from_numpy(tree.base, lr, dev),
        **{k: torch.tensor(np.asarray(getattr(tree, k)), device=dev)
           for k in MarlisaTrainState.TENSORS},
        prev_valid=bool(tree.prev_valid))


class BatchedMARLISA(BatchedSAC):
    """Vectorized MARLISA over ``n_districts`` instances of one dataset, on
    ``device`` (the CUDA card by default)."""

    extra_obs_dim = COORD_VARS

    def __init__(self, schema, cfg: TrainConfig = TrainConfig(), seed: int = 0,
                 iterations: int = 2, regression_update_every: int = 50, **kwargs):
        self.iterations = int(iterations)
        self.regression_update_every = int(regression_update_every)
        super().__init__(schema, cfg, seed=seed, **kwargs)

    # ------------------------------------------------------------------
    def _energy_coefficients(self):
        """Per-building dispatch-capacity weights (reference
        ``marlisa.py:404-418``) from the simulation-range demand sums."""
        spec = self.spec
        sl = slice(spec.simulation_start_time_step, spec.simulation_end_time_step + 1)
        # the reference works from annual demand estimates: the sums over
        # the simulation range are annualized, so that multi-year datasets
        # keep the same coordination-variable scale
        n_steps = sl.stop - sl.start
        years = max(n_steps * spec.seconds_per_time_step / 3600.0 / 8760.0, 1e-9)
        esc = []
        for b in spec.buildings:
            s = b.series
            solar = float(np.sum(b.pv_nominal_power * s["solar_generation"][sl] / 1000.0)) / years
            coef = (float(np.sum(s["dhw_demand"][sl])) / years / 0.9
                    + float(np.sum(s["cooling_demand"][sl])) / years / 3.5
                    + float(np.sum(s["heating_demand"][sl])) / years / 3.5
                    + float(np.sum(s["non_shiftable_load"][sl])) / years
                    - solar / 6.0)
            coef = max(0.3 * (coef + solar / 6.0), coef) / 8760.0
            esc.append(coef)
        total = sum(esc) or 1.0
        # normalized per-building weights, and the raw total that scales the
        # total-demand coordination variable (marlisa.py:415-418)
        return np.asarray([c / total for c in esc], np.float32), float(total)

    def _init_state(self, seed: int):
        D, A = self.cfg.n_districts, self.env_cfg.n_buildings
        esc, total = self._energy_coefficients()
        self.energy_size_coefficient = torch.tensor(esc, device=self.device)
        self.total_coefficient = float(total)
        # the capacity dispatched before each ring position (agents 0..A-1)
        self.cap_dispatched = torch.tensor(
            np.concatenate([[0.0], np.cumsum(esc)[:-1]]).astype(np.float32), device=self.device)
        F = self.enc_dim + self.act_dim + 1
        self.reg_dim = F
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.load_state(MarlisaTrainState(
            base=self._fresh_state(seed), cv=zeros(D, A, COORD_VARS),
            reg_xtx=zeros(A, F, F), reg_xty=zeros(A, F), reg_w=zeros(A, F),
            prev_obs=zeros(D, A, self.obs_dim), prev_act=zeros(D, A, self.act_dim),
            prev_rew=zeros(D, A), prev_valid=False))

    @property
    def base_state(self) -> TrainState:
        return self.state.base

    # ------------------------------------------------------------------
    def _coordination_ring(self, policy, obs_enc: torch.Tensor, cv0: torch.Tensor,
                           reg_w: torch.Tensor, noise: torch.Tensor,
                           deterministic: bool = False):
        """One action-selection pass: ``iterations`` sweeps of the
        sequential agent ring (reference ``marlisa.py:298-331``).
        ``obs_enc`` (D, A, K0), ``cv0`` (D, A, 2), ``reg_w`` (A, F) and
        standard normal ``noise`` (iterations, A, D, M); returns the (D, A,
        M) actions and the coordination variables each agent acted on."""
        D, A = obs_enc.shape[0], self.env_cfg.n_buildings
        cv = cv0.clone()
        expected = obs_enc.new_zeros((D, A))          # each agent's predicted net
        total_demand = obs_enc.new_zeros((D,))
        actions = obs_enc.new_zeros((D, A, self.act_dim))
        ones = obs_enc.new_ones((D, 1))
        with torch.no_grad():
            for it in range(self.iterations):
                for c in range(A):
                    nxt = (c + 1) % A
                    is_last = c == A - 1 and it == self.iterations - 1
                    one = slice(c, c + 1)
                    inp = torch.cat([obs_enc[:, c], cv[:, c]], dim=-1)
                    a_s, _, a_det = policy_sample(
                        functools.partial(policy, agents=one), inp[None], noise[it, c][None],
                        self.action_scale[one], self.action_bias[one], self.act_mask[one])
                    a_c = (a_det if deterministic else a_s)[0]           # (D, M)
                    exp_c = torch.cat([obs_enc[:, c], a_c, ones], dim=-1) @ reg_w[c]
                    exp_n = expected[:, nxt].clone()   # read before the write: with A = 1 it is c
                    expected[:, c] = exp_c
                    # the total-demand variable of the next agent in the ring
                    if not is_last:
                        total_demand = total_demand + (exp_c - exp_n)
                        cv[:, nxt, 0] = total_demand / self.total_coefficient
                    # the capacity dispatched before this agent
                    cv[:, c, 1] = self.cap_dispatched[c]
                    actions[:, c] = a_c
        return actions, cv

    # ------------------------------------------------------------------
    def _scan_step(self) -> torch.Tensor:
        cfg, ms = self.cfg, self.state
        ts = ms.base
        D, A = cfg.n_districts, self.env_cfg.n_buildings
        t = ts.step
        obs_enc = self._encoded_obs(ts.env_state)                      # (D, A, K0)
        explore = t < cfg.warmup_steps
        # the ring starts from zero coordination variables at every step
        # (reference marlisa.py:302-306); it runs during warmup too
        a_ring, cv_used = self._coordination_ring(
            ts.nets.policy, obs_enc, torch.zeros_like(ms.cv), ms.reg_w,
            self.draws.ring_noise(t, (self.iterations, A, D, self.act_dim)))
        if explore:
            a_env = self.draws.explore(t, self.act_low, self.act_high, D)
            cv_used = torch.zeros_like(cv_used)
        else:
            a_env = a_ring
        obs_cv = torch.cat([obs_enc, cv_used], dim=-1)

        env_state, out = district_step(self.env_cfg, self.params, ts.env_state,
                                       self._actions_dict(a_env))
        reward = out.reward * cfg.reward_scale                         # (D, A)

        # streaming ridge regression of the step's true net consumption
        feats = torch.cat([obs_enc, a_env, obs_enc.new_ones((D, A, 1))], dim=-1)
        ms.reg_xtx = ms.reg_xtx + torch.einsum("daf,dag->afg", feats, feats)
        ms.reg_xty = ms.reg_xty + torch.einsum("daf,da->af", feats,
                                               out.net_electricity_consumption)
        if (t + 1) % self.regression_update_every == 0:
            ms.reg_w = ridge_solve(ms.reg_xtx, ms.reg_xty)

        # episode auto-reset with freshly drawn windows (lockstep, as in
        # BatchedSAC)
        terminated = self._phase + 1 == self.env_cfg.time_steps - 1
        if terminated:
            env_state = self._broadcast_initial(
                self.draws.offsets(t, StepDraws.RESET, D, self.max_offset))

        # the previous step's transition, whose next observation is this
        # step's with the coordination variables its action saw
        S = ts.replay_done.shape[0]
        if ms.prev_valid:
            slot = ts.replay_pos
            self._store(slot, ms.prev_obs.reshape(D, -1), ms.prev_act, ms.prev_rew,
                        obs_cv.reshape(D, -1), 0.0)
            ts.replay_pos = (slot + 1) % S
            ts.replay_full = ts.replay_full or slot + 1 >= S

        slots_avail = S if ts.replay_full else ts.replay_pos
        if slots_avail * D >= cfg.batch_size and not explore:
            self._update(t, slots_avail)
        ts.env_state = env_state
        ts.step = t + 1
        ms.cv, ms.prev_obs, ms.prev_act, ms.prev_rew = cv_used, obs_cv, a_env, reward
        ms.prev_valid = not terminated       # a transition across a reset is dropped
        self._phase = 0 if terminated else self._phase + 1
        return reward.sum()

    # ------------------------------------------------------------------
    def evaluate(self, n_steps: int = None, baseline_condition: str = "_without_storage"):
        """KPI tables for every district under the deterministic policy with
        the live coordination ring (reference ``marlisa.py:298-331`` runs
        the same ring at ``deterministic=True``): the policy was trained on
        ring-made coordination variables, so it is evaluated on them too.
        Fresh districts with freshly drawn windows, as
        :meth:`BatchedSAC.evaluate`."""
        D, A = self.cfg.n_districts, self.env_cfg.n_buildings
        ts = self.base_state
        fresh = self._broadcast_initial(
            self.draws.offsets(ts.step, StepDraws.EVAL, D, self.max_offset))
        cv0 = torch.zeros((D, A, COORD_VARS), device=self.device)
        noise = torch.zeros((self.iterations, A, D, self.act_dim), device=self.device)

        def policy_fn(params, states):
            acts, _ = self._coordination_ring(ts.nets.policy, self._encoded_obs(states), cv0,
                                              self.state.reg_w, noise, deterministic=True)
            return self._actions_dict(acts)

        return evaluate_districts(self.env_cfg, self.params, fresh, policy_fn, n_steps,
                                  baseline_condition, device=self.device)
