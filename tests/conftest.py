"""Test configuration.

Tests run on the CPU (JAX_PLATFORMS=cpu) with a virtual 8-device mesh so
every shard_map / collective path is exercised without a card (SURVEY.md
§4 "distributed without a cluster"). Environment must be set before jax
is imported anywhere. Tests that need an NVIDIA GPU take the ``gpu``
fixture, which skips them elsewhere; `python chip_smoke.py` covers the
same paths on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Routing calibration: never auto-measure in tests, and never read a
# calibration cached by an earlier run — gates run on the built-in
# constants unless a test injects its own file.
os.environ.setdefault("KMER_CALIBRATE", "0")
os.environ.setdefault(
    "KMER_CALIBRATION_FILE",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "no_calibration.json"),
)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xD9A)


def random_dna(rng, length: int, invalid_frac: float = 0.0) -> str:
    """Random ACGT string with an optional fraction of invalid 'N' bases."""
    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    idx = rng.integers(0, 4, size=length)
    out = alphabet[idx]
    if invalid_frac > 0:
        mask = rng.random(length) < invalid_frac
        out = np.where(mask, np.uint8(ord("N")), out)
    return out.tobytes().decode("ascii")


@pytest.fixture
def make_dna(rng):
    def _make(length, invalid_frac=0.0):
        return random_dna(rng, length, invalid_frac)

    return _make


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at test time,
    never at import, so every xdist worker collects the same tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: python chip_smoke.py)")
