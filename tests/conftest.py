"""Test configuration: by default run JAX on a virtual 8-device CPU mesh.

Sharding paths are validated on ``xla_force_host_platform_device_count=8``
CPU devices. An explicit ``JAX_PLATFORMS`` in the environment wins, so the
tests marked ``gpu`` can run on a card (``JAX_PLATFORMS=cuda,cpu python -m
pytest -m gpu tests/``); they skip, from inside their fixture, where no
card is present.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if "jax" in sys.modules:
    # a pytest plugin (jaxtyping's, for one) imported jax before this
    # file: hand it the choice above while no backend is up yet
    sys.modules["jax"].config.update(
        "jax_platforms", os.environ["JAX_PLATFORMS"]
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: JAX finds none here")
    return gpus[0]
