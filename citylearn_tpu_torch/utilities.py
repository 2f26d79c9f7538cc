"""Noise utilities (reference ``citylearn/utilities.py``)."""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np


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
