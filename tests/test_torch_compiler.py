"""The PyTorch port's schema compiler produces the same DistrictSpec as the
JAX package's on a seeded synthetic battery+PV dataset, and the port
imports neither JAX nor any module of the JAX package."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from citylearn_tpu.compiler.schema import compile_schema as jax_compile
from citylearn_tpu_torch.compiler.schema import compile_schema
from citylearn_tpu_torch.synthetic import write_battery_pv_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def schema_path(tmp_path_factory):
    return write_battery_pv_dataset(str(tmp_path_factory.mktemp("ds")), 5, 200, seed=3)


def _assert_same(a, b, path="spec"):
    """Field-by-field equality of two specs (dataclasses of different
    modules), arrays compared by dtype, shape and value."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("central_agent", [False, True])
def test_spec_equals_jax(schema_path, central_agent):
    kw = dict(central_agent=central_agent, episode_time_steps=169)
    ours = compile_schema(schema_path, **kw)
    ref = jax_compile(schema_path, **kw)
    _assert_same(ours, ref)
    assert ours.n_buildings == 5
    assert ours.buildings[0].series["non_shiftable_load"].shape == (200,)
    assert ours.observation_names() == ref.observation_names()


def test_unsupported_blocks_raise(schema_path, tmp_path, monkeypatch):
    """What the JAX package's compiler refuses, the port refuses with the
    same exception: a battery autosize without ``battery_choices.yaml``
    and a dynamics block on a plain building (autosize itself compiles:
    ``tests/test_torch_autosize.py``)."""
    import json

    with open(schema_path) as f:
        schema = json.load(f)
    schema["root_directory"] = os.path.dirname(schema_path)
    monkeypatch.setenv("CITYLEARN_MISC_ROOT", str(tmp_path))
    sized = json.loads(json.dumps(schema))
    next(iter(sized["buildings"].values()))["electrical_storage"]["autosize"] = True
    dynamic = json.loads(json.dumps(schema))
    next(iter(dynamic["buildings"].values()))["dynamics"] = {
        "type": "citylearn.dynamics.LSTMDynamics", "attributes": {}}
    for bad, error, match in ((sized, FileNotFoundError, "battery_choices.yaml"),
                              (dynamic, NotImplementedError, "with dynamics")):
        for compile_fn in (compile_schema, jax_compile):
            with pytest.raises(error, match=match):
                compile_fn(bad)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import citylearn_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'citylearn_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 15, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'citylearn_tpu' or m.startswith('citylearn_tpu.')\n"
        "       or m.split('.')[0] in ('pandas', 'yaml', 'flax', 'gymnasium')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
