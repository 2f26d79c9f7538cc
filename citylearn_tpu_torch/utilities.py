"""IO, noise and profiling utilities (reference ``citylearn/utilities.py``)."""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Iterable, Union

import numpy as np


class FileHandler:
    @staticmethod
    def read_json(filepath: str) -> dict:
        with open(filepath) as f:
            return json.load(f)

    @staticmethod
    def write_json(filepath: str, data: dict, **kwargs):
        kwargs.setdefault("indent", 2)
        with open(filepath, "w") as f:
            json.dump(data, f, default=str, **kwargs)

    @staticmethod
    def read_yaml(filepath: str) -> dict:
        import yaml

        with open(filepath) as f:
            return yaml.safe_load(f)

    @staticmethod
    def write_yaml(filepath: str, data: dict, **kwargs):
        import yaml

        with open(filepath, "w") as f:
            yaml.safe_dump(data, f, **kwargs)

    @staticmethod
    def read_pickle(filepath: str) -> Any:
        with open(filepath, "rb") as f:
            return pickle.load(f)

    @staticmethod
    def write_pickle(filepath: str, data: Any, **kwargs):
        with open(filepath, "wb") as f:
            pickle.dump(data, f, **kwargs)


class NoiseUtils:
    """Gaussian observation noise (reference ``utilities.py:148-174``).

    The reference draws from the unseeded global RNG; we accept an optional
    seeded generator for reproducible noisy datasets."""

    @staticmethod
    def generate_gaussian_noise(input_data: Union[np.ndarray, Iterable[float]],
                                noise_std: float,
                                rng: np.random.RandomState = None) -> np.ndarray:
        arr = np.asarray(input_data)
        if noise_std <= 0:
            return np.zeros(arr.shape)
        rng = np.random if rng is None else rng
        return rng.normal(loc=0, scale=noise_std, size=arr.shape)

    @staticmethod
    def generate_scaled_noise(input_data, noise_std: float, scale: float = 1.0,
                              rng: np.random.RandomState = None) -> np.ndarray:
        return NoiseUtils.generate_gaussian_noise(input_data, noise_std, rng) * scale

    @staticmethod
    def make_noise_fn(noise_std: float, rng: np.random.RandomState = None):
        """``noise(n) -> (n,) float64`` drawing from ``rng`` when
        ``noise_std > 0``, zeros (and no stream consumption) otherwise —
        the reference's ``generate_gaussian_noise`` gating
        (``utilities.py:166-170``)."""
        def noise(n: int) -> np.ndarray:
            return NoiseUtils.generate_gaussian_noise(np.empty(n), noise_std, rng)
        return noise


class Profiler:
    """``torch.profiler`` around a hot region: host operations, and the
    card's kernels when CUDA is available, written as a Chrome trace
    (``trace.json`` under ``log_dir``) when the block ends::

        with Profiler("/tmp/trace") as p:
            evaluate_scripted(cfg, params, policy, n_districts=4096)
        p.trace_path, p.profile.key_averages(), p.recording.spans

    The block also switches the program's tracer on
    (:func:`citylearn_tpu_torch.tracing.recording`): every span the program
    opens (``train.update``, ``sac.critic``, ``env.step``, the kernel
    wrappers' ``battery_episode`` ...) is a ``record_function`` range in the
    trace, so the trace names the program's layers, and ``recording`` holds
    the spans. Inside a ``tracing.recording()`` block, ``recording`` is that
    block's, which keeps every span.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.trace_path = os.path.join(log_dir, "trace.json")
        self.profile = None
        self.recording = None
        self._tracing = None

    def __enter__(self):
        import torch

        from citylearn_tpu_torch import tracing

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.profile = torch.profiler.profile(activities=activities)
        self.profile.__enter__()
        self._tracing = tracing.recording(annotate=True)
        self.recording = self._tracing.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        self._tracing.__exit__(*exc)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile.export_chrome_trace(self.trace_path)
        return False
