import os
import sys
import tempfile

# tests see ONE device (the dry-run sets its own flags in-process)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# hermetic schedule cache: never read/write the user's ~/.cache/repro
os.environ.setdefault(
    "REPRO_TUNE_CACHE",
    os.path.join(tempfile.mkdtemp(prefix="repro-tune-test-"),
                 "schedules.json"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    # registered here (no pytest.ini/pyproject): `-m "not slow"` is the
    # fast CI lane; the subprocess sharded-compile tests carry the marker
    config.addinivalue_line(
        "markers",
        "slow: subprocess-spawning sharded-compile tests; excluded from "
        "the fast lane (-m 'not slow'), run by the full CI lane")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's hand-written kernels); "
        "skips without one")
    _configure_hypothesis(config)


def _configure_hypothesis(config):
    """Pin down the property suites' randomness.

    CI runs the derandomized profile (examples derived from the test
    body, not the clock) so the fast lane is reproducible and a red
    build always replays.  Local runs keep hypothesis's randomized
    search — more bug-finding power per run — and the plugin's own
    ``--hypothesis-seed N`` flag is the escape hatch to replay a
    specific local failure; passing it forces the randomized profile so
    the seed actually takes effect.  No-op when hypothesis isn't
    installed (the property tests importorskip themselves away)."""
    try:
        from hypothesis import settings
    except ImportError:
        return
    settings.register_profile("repro-ci", derandomize=True,
                              max_examples=50, deadline=None,
                              print_blob=True)
    settings.register_profile("repro-dev", deadline=None,
                              print_blob=True)
    try:
        seeded = config.getoption("--hypothesis-seed") is not None
    except ValueError:          # plugin not active for this run
        seeded = False
    if not seeded and os.environ.get("CI"):
        settings.load_profile("repro-ci")
    else:
        settings.load_profile("repro-dev")
