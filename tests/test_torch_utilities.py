"""The port's ``utilities.py`` against the JAX package's: ``FileHandler``'s
JSON, YAML and pickle round trips (each package reads what the other
wrote, byte-equal files), and the ``torch.profiler`` ``Profiler``, which on
the CPU writes a Chrome trace naming the profiled operations. No
tolerance: files and values are compared exactly."""

import json
import os

import numpy as np
import pytest
import torch

from citylearn_tpu.utilities import FileHandler as JaxFileHandler
from citylearn_tpu_torch.utilities import FileHandler, NoiseUtils, Profiler

DATA = {"name": "district", "buildings": [1, 2, 3], "nested": {"ratio": 0.25, "on": True},
        "none": None}


@pytest.mark.parametrize("kind", ["json", "yaml", "pickle"])
def test_file_handler_round_trips_equal_jax(tmp_path, kind):
    write, read = getattr(FileHandler, f"write_{kind}"), getattr(FileHandler, f"read_{kind}")
    jwrite, jread = getattr(JaxFileHandler, f"write_{kind}"), getattr(JaxFileHandler, f"read_{kind}")
    ours, ref = str(tmp_path / f"ours.{kind}"), str(tmp_path / f"ref.{kind}")
    write(ours, DATA)
    jwrite(ref, DATA)
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    assert read(ours) == jread(ours) == DATA
    assert read(ref) == DATA


def test_write_json_keeps_the_defaults(tmp_path):
    path = str(tmp_path / "a.json")
    FileHandler.write_json(path, {"array": np.float32(1.5), "when": np.datetime64("2021-01-01")})
    with open(path) as f:
        text = f.read()
    assert text.startswith("{\n  ")                        # indent 2 by default
    assert json.loads(text) == {"array": "1.5", "when": "2021-01-01"}    # default=str
    FileHandler.write_json(path, DATA, indent=None)
    with open(path) as f:
        assert "\n" not in f.read()


def test_profiler_writes_a_trace_naming_the_profiled_ops(tmp_path):
    log_dir = str(tmp_path / "trace")
    a, b = torch.randn(64, 32), torch.randn(32, 16)
    with Profiler(log_dir) as prof:
        c = torch.matmul(a, b)
        with torch.profiler.record_function("district_block"):
            d = torch.tanh(c).sum()
    assert prof.trace_path == os.path.join(log_dir, "trace.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "district_block" in names
    assert any(n and n.startswith("aten::mm") for n in names)
    assert any(n == "aten::tanh" for n in names)
    assert float(d) == float(torch.tanh(a @ b).sum())
    assert any(e.key == "aten::tanh" for e in prof.profile.key_averages())


def test_profiler_writes_its_trace_when_the_block_raises(tmp_path):
    log_dir = str(tmp_path / "trace")
    with pytest.raises(ValueError):
        with Profiler(log_dir) as prof:
            torch.ones(3).add_(1)
            raise ValueError("stop")
    assert os.path.isfile(prof.trace_path)


def test_noise_utils_unchanged():
    rng, ref = np.random.RandomState(3), np.random.RandomState(3)
    np.testing.assert_array_equal(NoiseUtils.generate_gaussian_noise(np.zeros(5), 0.5, rng),
                                  ref.normal(0, 0.5, 5))
    assert not NoiseUtils.make_noise_fn(0.0, rng)(4).any()
