"""The port's compiler and packer on occupant districts against the JAX
package's: ``_load_occupant`` (the logistic parameters and the two pickled
decision trees flattened to node arrays), the missing-tree fallback to an
inert one-leaf tree, the packed ``OccupantParams`` with its seeded uniforms,
the static configuration, the ``occ_*`` leaves of the initial state and the
``params_from_numpy`` round trip. The fixtures are the repository's
``tests/golden/quebec_occ`` (two buildings with real trees; unpickling them
needs scikit-learn) and the quebec shape of
``citylearn_tpu_torch.synthetic.write_neighborhood_dataset`` (no tree files).
Everything here is exact: both packages run the same numpy code on the same
files."""

import dataclasses
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import _load_occupant as jax_load_occupant
from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu_torch.compiler.schema import _load_occupant, compile_schema
from citylearn_tpu_torch.core.params import initial_state, pack, params_from_numpy
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.types import flatten
from citylearn_tpu_torch.synthetic import write_neighborhood_dataset

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "quebec_occ")
STEPS = 169


def jax_leaves(tree):
    name = lambda k: str(getattr(k, "name", getattr(k, "idx", None)))
    return {".".join(name(k) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def districts(tmp_path_factory):
    synthetic = write_neighborhood_dataset(str(tmp_path_factory.mktemp("quebec")), 6, 400,
                                           seed=3, quebec=True)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # the synthetic district's missing trees
        for name, path in (("golden", os.path.join(GOLDEN, "schema.json")),
                           ("synthetic", synthetic)):
            kw = dict(episode_time_steps=STEPS)
            out[name] = (path, compile_schema(path, **kw), jax_compile(path, **kw))
    return out


@pytest.mark.parametrize("name", ["golden", "synthetic"])
def test_occupant_spec_equals_jax(districts, name):
    _, spec, jspec = districts[name]
    assert len(spec.buildings) == len(jspec.buildings)
    for b, jb in zip(spec.buildings, jspec.buildings):
        occ, jocc = b.occupant, jb.occupant
        assert occ is not None and jocc is not None
        for f in dataclasses.fields(occ):
            ours, ref = getattr(occ, f.name), getattr(jocc, f.name)
            if isinstance(ours, np.ndarray):
                assert ours.dtype == ref.dtype and ours.shape == ref.shape, f.name
                np.testing.assert_array_equal(ours, ref, err_msg=f.name)
            else:
                assert ours == ref, f.name
        assert occ.set_point_hold_time_steps == 4
        assert b.active_actions == jb.active_actions
        assert b.observation_low == jb.observation_low
        assert b.observation_high == jb.observation_high
    trees = spec.buildings[0].occupant.tree_feature
    if name == "golden":
        # real trees: internal nodes split on the three features
        assert (trees >= 0).any() and spec.buildings[0].occupant.max_depth == 3
    else:
        assert trees.tolist() == [[-2], [-2]]


def test_load_occupant_reads_the_trees():
    """``_load_occupant`` on each golden building: node arrays, deltas from
    the delta map, the parameters over the simulation window."""
    import json

    with open(os.path.join(GOLDEN, "schema.json")) as f:
        schema = json.load(f)
    for block in (b["occupant"] for b in schema["buildings"].values()):
        ours = _load_occupant(block, GOLDEN, 100, 399)
        ref = jax_load_occupant(block, GOLDEN, 100, 399)
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(ref, f.name)
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name
        assert ours.a_increase.shape == (300,) and ours.a_increase.dtype == np.float32
        assert set(np.unique(ours.tree_delta)) <= {0.0, 0.5, 1.5}
        assert ours.set_point_hold_time_steps == 2 ** 30      # the block itself sets none


def test_missing_tree_is_inert(tmp_path):
    path = write_neighborhood_dataset(str(tmp_path), 2, 60, quebec=True)
    with pytest.warns(UserWarning, match="setpoint_increase.pkl missing"):
        spec = compile_schema(path)
    occ = spec.buildings[1].occupant
    assert occ.tree_children_left.tolist() == [[-1], [-1]]
    assert occ.tree_feature.tolist() == [[-2], [-2]]
    assert occ.tree_delta.tolist() == [[0.0], [0.0]] and occ.max_depth == 1


@pytest.mark.parametrize("name", ["golden", "synthetic"])
def test_pack_equals_jax(districts, name):
    _, spec, jspec = districts[name]
    cfg, params, _ = pack(spec, device="cpu")
    jcfg, jparams, _ = jax_pack(jspec)
    assert cfg.__dict__ == jcfg.__dict__
    assert cfg.has_occupant and cfg.occupant_tree_depth == (3 if name == "golden" else 1)
    carried = flatten(params_from_numpy(jax_leaves(jparams), device="cpu"))
    ours = flatten(params)
    # 61 leaves of a plain district, 9 per dynamics group and 3 per layer,
    # and the occupant's 12
    n_leaves = 61 + sum(9 + 3 * L for _, L, *_ in cfg.dyn_groups) + 12
    assert set(ours) == set(carried) and len(ours) == n_leaves
    for k, v in ours.items():
        assert v.dtype == carried[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), carried[k].numpy(), err_msg=k)
    occ = params.occupant
    # one RandomState(max(seed, 1) + t) draw per episode step
    seed = max(spec.random_seed, 1)
    rand = [np.float32(np.random.RandomState(seed + t).uniform()) for t in range(STEPS)]
    assert occ.random_probability.tolist() == rand
    assert occ.hold_time_steps.tolist() == [4] * cfg.n_buildings
    assert occ.lookback.tolist() == [12] * cfg.n_buildings
    assert occ.a_increase.shape == (STEPS, cfg.n_buildings)


@pytest.mark.parametrize("name", ["golden", "synthetic"])
def test_initial_state_equals_jax(districts, name):
    _, spec, jspec = districts[name]
    cfg, params, _ = pack(spec, device="cpu")
    jcfg, jparams, _ = jax_pack(jspec)
    ours = flatten(initial_state(cfg, params, 7))
    ref = jax_leaves(jax_initial_state(jcfg, jparams, 7))
    assert set(ours) == set(ref)
    for k, v in ours.items():
        assert str(v.dtype).split(".")[-1] == str(ref[k].dtype), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    B = cfg.n_buildings
    assert torch.isnan(ours["occ_csp_override"]).all() and ours["occ_hold_counter"].tolist() \
        == [-1] * B
    batched = batched_initial_states(cfg, params, 3, device="cpu")
    assert batched.occ_hsp_override.shape == (3, B)
    assert batched.occ_hold_counter.dtype == torch.int32
