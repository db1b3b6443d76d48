import os

# Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
# without accelerator hardware.  The platform is forced through jax.config as
# well as the environment, in case jax was imported before this file ran
# (XLA_FLAGS still applies because no CPU backend has been instantiated yet).
# Tests that need the card are marked ``chip`` and take the ``gpu`` fixture;
# with KMER_TEST_PLATFORM=gpu the CPU stays the default backend and the card
# is added beside it.
_PLATFORMS = "cpu,cuda" if os.environ.get("KMER_TEST_PLATFORM") == "gpu" else "cpu"
os.environ["JAX_PLATFORMS"] = _PLATFORMS
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", _PLATFORMS)


@pytest.fixture
def gpu():
    """The card, made JAX's default device for the test; skips unless the
    run asked for it.  Gated on ``KMER_TEST_PLATFORM=gpu`` at run time, in
    the fixture: the suite is forced onto the CPU above, so only that run
    brings up the CUDA backend (README, "Running it").  The default is set
    process-wide, not per thread, so work the engine submits from its
    worker threads lands on the card too."""
    if os.environ.get("KMER_TEST_PLATFORM") != "gpu":
        pytest.skip("needs a GPU (run with KMER_TEST_PLATFORM=gpu)")
    dev = jax.devices("gpu")[0]
    before = jax.config.jax_default_device
    jax.config.update("jax_default_device", dev)
    yield dev
    jax.config.update("jax_default_device", before)
