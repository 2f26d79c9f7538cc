"""The port's Gym env against the JAX package's on the neighborhood
districts: the seeded synthetic EULP-shaped and quebec-shaped districts
(heterogeneous LSTM buildings, signed partial load; occupants with the
quebec shape) and ``tests/golden/quebec_occ`` (occupant decision trees
read with scikit-learn): whole episodes decentral and central, the spaces
and ``get_metadata``, and a reseeded random split scored part of the way
through under other evaluation conditions. Tolerance 1e-5 of each series'
scale, as in ``test_torch_env.py``."""

import numpy as np
import pytest

import _env_parity as ep
from citylearn_tpu import EvaluationCondition as JaxEvaluationCondition
from citylearn_tpu_torch import EvaluationCondition

TOL = 1e-5
FAMILIES = list(ep.NEIGHBORHOOD_WRITERS)
#: episode rows, decentral and central: three days and one (the JAX
#: steps of these districts are the slow part of this file)
EPISODE = {False: 72, True: 24}


@pytest.fixture(scope="module")
def schemas(tmp_path_factory):
    return ep.write_all(tmp_path_factory, ep.NEIGHBORHOOD_WRITERS)


@pytest.mark.parametrize("central", [False, True], ids=["decentral", "central"])
@pytest.mark.parametrize("family", FAMILIES)
def test_episode_matches_jax(schemas, family, central):
    ep.check_episode(schemas[family], central, EPISODE[central], TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_spaces_and_metadata_match_jax(schemas, family):
    ep.check_spaces_and_metadata(schemas[family])


def test_reset_with_seed_and_mid_episode_evaluate(schemas):
    """``reset(seed=...)`` reseeds the random split; ``evaluate()`` part of
    the way through an episode reads the unwritten current row as the
    reference does."""
    ours, ref = ep.pair(schemas["eulp"], episode_time_steps=48, random_episode_split=True)
    ep.run_episode(ours, ref, 0, seed=1, tol=TOL)
    for env in (ours, ref):
        env.reset(seed=11)
    assert ours.episode_tracker.episode_start_time_step \
        == ref.episode_tracker.episode_start_time_step
    rng = np.random.RandomState(2)
    for _ in range(20):
        acts = ep.random_actions(ref, rng)
        ours.step(acts)
        ref.step(acts)
    ep.assert_frames_close(ours.evaluate(), ref.evaluate(), TOL)
    for ours_c, ref_c in ((EvaluationCondition.WITHOUT_STORAGE_AND_PV,
                           JaxEvaluationCondition.WITHOUT_STORAGE_AND_PV),
                          ("_without_storage", "_without_storage")):
        ep.assert_frames_close(ours.evaluate(baseline_condition=ours_c, comfort_band=1.5),
                               ref.evaluate(baseline_condition=ref_c, comfort_band=1.5), TOL)
