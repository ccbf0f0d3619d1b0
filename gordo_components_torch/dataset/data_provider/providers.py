"""Data providers (counterpart of ``RandomDataProvider`` in
``gordo_components_tpu/dataset/data_provider/providers.py``).

``RandomDataProvider`` makes deterministic synthetic sensor data: per tag a
sine wave (frequency, phase, amplitude and offset from a hash of the tag
name and the seed) plus gaussian noise, sampled every ``freq`` from the
range's start. It draws exactly the numbers the JAX package's provider
draws, so both packages train on the same data.
"""

import hashlib
from typing import Iterable, List

import numpy as np

from gordo_components_torch.dataset.data_provider.base import GordoBaseDataProvider, Series
from gordo_components_torch.dataset.sensor_tag import SensorTag
from gordo_components_torch.dataset.times import resolution_ns
from gordo_components_torch.utils import capture_args


class RandomDataProvider(GordoBaseDataProvider):
    """Deterministic synthetic sensor data, one sample every ``freq``."""

    @capture_args
    def __init__(self, freq: str = "1min", noise: float = 0.1, seed: int = 0):
        self.freq = freq
        self.noise = noise
        self.seed = seed

    def load_series(self, from_ns: int, to_ns: int, tag_list: List[SensorTag]) -> Iterable[Series]:
        if from_ns >= to_ns:
            raise ValueError(f"from {from_ns} must precede to {to_ns} (ns)")
        step = resolution_ns(self.freq)
        n = -(-(to_ns - from_ns) // step)
        index = from_ns + step * np.arange(n, dtype=np.int64)
        # float32 end to end, with the argument built in float64 wrapped mod
        # 2 pi past 2^17 samples, where float32 phases would drift (the JAX
        # package's generator, to the bit)
        two_pi = 2 * np.pi
        small = n <= (1 << 17)
        t = np.arange(n, dtype=np.float32 if small else np.float64)
        two_pi_t32 = np.float32(two_pi) * t if small else None
        for tag in tag_list:
            digest = hashlib.sha256(f"{tag.name}|{self.seed}".encode()).digest()
            rng = np.random.Generator(np.random.Philox(key=int.from_bytes(digest[:16], "little")))
            freq = rng.uniform(0.001, 0.1)
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.5, 2.0)
            offset = rng.uniform(-1, 1)
            if small:
                arg = np.float32(freq) * two_pi_t32 + np.float32(phase)
            else:
                arg = np.mod(freq * two_pi * t + phase, two_pi).astype(np.float32)
            values = np.float32(offset) + np.float32(amp) * np.sin(arg, dtype=np.float32)
            if self.noise:
                values += np.float32(self.noise) * rng.standard_normal(len(values), dtype=np.float32)
            yield Series(tag.name, index, values)
