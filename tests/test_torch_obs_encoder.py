"""The port's observation matrix and encoder against the JAX package's:
``obs_static`` from ``pack`` equals JAX's exactly, the encoder specs
equal JAX's exactly, and the encoded observations agree within 1e-6
(the sine and cosine of torch and of XLA:CPU may differ in the last
float32 bit)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu.core import obs_encoder as jax_enc
from citylearn_tpu.core.params import pack as jax_pack
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.core import obs_encoder as enc
from citylearn_tpu_torch.core.params import pack
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

B = 4


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """A district whose buildings observe different subsets: the last
    one drops two observations, so its encoder is padded."""
    path = write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), B, 120, seed=4)
    with open(path) as f:
        schema = json.load(f)
    schema["root_directory"] = os.path.dirname(path)
    last = list(schema["buildings"])[-1]
    schema["buildings"][last]["inactive_observations"] = ["day_type", "solar_generation"]
    spec, jspec = compile_schema(schema), jax_compile(schema)
    return (spec, *pack(spec, device="cpu")), (jspec, *jax_pack(jspec))


def test_obs_static_equals_jax(packed):
    (_, _, params, layout), (_, _, jparams, jlayout) = packed
    assert layout.union_names == jlayout.union_names
    np.testing.assert_array_equal(params.obs_static.numpy(), np.asarray(jparams.obs_static))
    # state-derived observations read zero; data-driven ones do not
    col = layout.column("electrical_storage_soc")
    assert not params.obs_static[:, :, col].any()
    assert params.obs_static[:, :, layout.column("hour")].min() == 1


def test_encoder_specs_equal_jax(packed):
    (spec, _, _, layout), (jspec, _, _, jlayout) = packed
    ours = enc.pad_encoder_specs([enc.build_encoder_spec(spec, layout, i, device="cpu")
                                  for i in range(B)])
    ref = jax_enc.pad_encoder_specs([jax_enc.build_encoder_spec(jspec, jlayout, i)
                                     for i in range(B)])
    assert len({int(e.src.shape[0]) for e in ours}) == 1
    for a, b in zip(ours, ref):
        for field in enc.EncoderSpec._fields:
            np.testing.assert_array_equal(getattr(a, field).numpy(), np.asarray(getattr(b, field)),
                                          err_msg=field)
    assert (ours[-1].kind == 4).sum() > 0           # the padded building


def test_encode_obs_matches_jax(packed):
    (spec, _, params, layout), (jspec, _, jparams, jlayout) = packed
    specs = enc.pad_encoder_specs([enc.build_encoder_spec(spec, layout, i, device="cpu")
                                   for i in range(B)])
    jspecs = jax_enc.pad_encoder_specs([jax_enc.build_encoder_spec(jspec, jlayout, i)
                                        for i in range(B)])
    rows = params.obs_static                          # (T, B, K_union)
    stacked = enc.encode_obs(enc.stack_encoder_specs(specs), rows)
    assert stacked.shape == (rows.shape[0], B, specs[0].src.shape[0])
    for i in range(B):
        ref = np.asarray(jax.jit(jax_enc.encode_obs)(jspecs[i], jparams.obs_static[:, i]))
        np.testing.assert_allclose(enc.encode_obs(specs[i], rows[:, i]).numpy(), ref,
                                   rtol=0, atol=1e-6, err_msg=f"building {i}")
        # the stacked form encodes each building with its own spec
        assert torch.equal(stacked[:, i], enc.encode_obs(specs[i], rows[:, i]))
    # sin/cos of the hour, the day-type one-hot, min-max features in [0, 1]
    assert stacked.abs().max() <= 1.0 + 1e-6
