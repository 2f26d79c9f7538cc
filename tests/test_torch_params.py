"""The port's packed parameters and initial state equal the JAX
package's, leaf by leaf, on a seeded synthetic battery+PV dataset."""

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core.params import initial_state as jax_initial_state
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core.params import initial_state, pack, params_from_numpy
from citylearn_tpu_torch.core.rollout import batched_initial_states
from citylearn_tpu_torch.core.types import flatten
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset


def jax_leaves(tree):
    """{"field.subfield": numpy array} of a JAX pytree of dataclasses."""
    return {".".join(k.name for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=[False, True], ids=["decentral", "central"])
def packed(request, tmp_path_factory):
    path = write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), 5, 200, seed=1)
    kw = dict(central_agent=request.param, episode_time_steps=169)
    return pack(compile_schema(path, **kw), device="cpu"), jax_pack(jax_compile(path, **kw))


def test_pack_equals_jax(packed):
    (cfg, params, layout), (jcfg, jparams, jlayout) = packed
    assert cfg.__dict__ == jcfg.__dict__
    assert layout.union_names == jlayout.union_names
    assert layout.building_indices == jlayout.building_indices
    carried = flatten(params_from_numpy(jax_leaves(jparams), device="cpu"))
    ours = flatten(params)
    assert set(ours) == set(carried) and len(ours) == 69
    for k, v in ours.items():
        assert v.dtype == carried[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), carried[k].numpy(), err_msg=k)


@pytest.mark.parametrize("offset", [0, 7])
def test_initial_state_equals_jax(packed, offset):
    (cfg, params, _), (jcfg, jparams, _) = packed
    ours = flatten(initial_state(cfg, params, offset))
    ref = jax_leaves(jax_initial_state(jcfg, jparams, offset))
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    batched = batched_initial_states(cfg, params, 3, offset, device="cpu")
    assert batched.battery_soc.shape == (3, 5)
    assert torch.equal(batched.t, torch.zeros(3, dtype=torch.int32))


def test_entry_point_without_device_raises_without_card(packed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    (cfg, params, _), _ = packed
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_initial_states(cfg, params, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({})
