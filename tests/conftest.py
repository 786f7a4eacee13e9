"""Test config: force an 8-device virtual CPU mesh before JAX import.

Multi-device sharding is tested on a virtual mesh (standard JAX
practice). The GPU paths run through `python chip_smoke.py` on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"  # hard override of the ambient platform
os.environ.pop("JAX_PLATFORM_NAME", None)
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# jax may already be imported (e.g. by a pytest plugin) before this file
# runs, so switch the platform through the config API as well (works
# before any backend is initialized).
import jax

jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_ROOT = pathlib.Path("/root/reference")
LIAM_OUTPUT = REFERENCE_ROOT / "example" / "public" / "liam" / "output"


@pytest.fixture(scope="session")
def liam_output():
    """The reference sample dataset (250 .drc + 50 .ktx2) as golden corpus."""
    if not LIAM_OUTPUT.exists():
        pytest.skip("reference liam corpus not available")
    return LIAM_OUTPUT
