"""The port's package surface on the CPU: every name ``_EXPORTS`` lists
resolves on import, and importing every module of the package loads
neither JAX nor the JAX package nor pandas nor scikit-learn (the card's
machine has none of them; scikit-learn is imported by ``pickle`` only when
an occupant's decision trees are read)."""

import importlib
import pkgutil
import subprocess
import sys

import pytest

import citylearn_tpu_torch

MODULES = sorted(m.name for m in pkgutil.walk_packages(citylearn_tpu_torch.__path__,
                                                       "citylearn_tpu_torch."))


@pytest.mark.parametrize("name", sorted(citylearn_tpu_torch._EXPORTS))
def test_export_resolves(name):
    obj = getattr(citylearn_tpu_torch, name)
    module = importlib.import_module(citylearn_tpu_torch._EXPORTS[name])
    assert obj is getattr(module, name)


def test_entry_points_of_every_family_are_exported():
    for name in ("run_battery_episode", "run_thermal_episode", "run_ev_episode",
                 "run_lstm_episode", "run_neighborhood_episode", "evaluate_scripted"):
        assert name in citylearn_tpu_torch._EXPORTS
    with pytest.raises(AttributeError):
        citylearn_tpu_torch.not_a_name


def test_modules_import_no_jax_pandas_or_sklearn():
    code = ("import sys, importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'citylearn_tpu', 'pandas', 'sklearn')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=citylearn_tpu_torch.__path__[0] + "/..")
    assert out.stdout.strip() == "[]", out.stdout
    assert "citylearn_tpu_torch.ops.neighborhood" in MODULES
    assert "citylearn_tpu_torch.ops.postpass" in MODULES
