import os
import sys
from pathlib import Path

import pytest

# Tests must see the real single CPU device (the dry-run sets 512 in its own
# process); make sure no leaked XLA_FLAGS reach us.
os.environ.pop("XLA_FLAGS", None)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

# ---------------------------------------------------------------------------
# Shared hypothesis profiles.  Property-test modules use the *active* profile
# (``SETTINGS = settings()``) instead of hard-coding example counts, so one
# env var switches the whole suite's thoroughness:
#
#   tier-1 fast lane (default) ...... HYPOTHESIS_PROFILE=ci       (15 examples)
#   CI nightly / full matrix ........ HYPOTHESIS_PROFILE=nightly (150 examples)
# ---------------------------------------------------------------------------
try:
    from hypothesis import HealthCheck, settings

    _COMMON = dict(deadline=None, suppress_health_check=[HealthCheck.too_slow])
    settings.register_profile("ci", max_examples=15, **_COMMON)
    settings.register_profile("nightly", max_examples=150, **_COMMON)
    settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))
except ImportError:  # property-test modules importorskip hypothesis themselves
    pass


# ---------------------------------------------------------------------------
# ``slow`` marker: heavy tests (multi-second jit compiles, end-to-end serving,
# large golden grids) are excluded from the tier-1 fast lane so a local
# ``pytest -x -q`` stays well under two minutes.  CI's full matrix runs them
# with ``--runslow`` (or RUN_SLOW=1).
# ---------------------------------------------------------------------------


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="run tests marked slow (the CI full matrix)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy test excluded from the tier-1 fast lane "
        "(enable with --runslow or RUN_SLOW=1)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card and the CUDA toolkit; skips where "
        "torch.cuda.is_available() is False",
    )


def run_slow_enabled(value: str | None) -> bool:
    """Interpret the RUN_SLOW env var: unset / empty / common falsy spellings
    ("0", "false", "no", "off", any case, surrounding whitespace) leave the
    fast lane on; anything else enables the slow tests.  Kept as a pure
    helper so CI forks can't silently regress the truthiness rules (see the
    regression tests in test_conftest_runslow.py)."""
    return (value or "").strip().lower() not in ("", "0", "false", "no", "off")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow") or run_slow_enabled(os.environ.get("RUN_SLOW")):
        return
    skip_slow = pytest.mark.skip(reason="slow: excluded from the fast lane (use --runslow)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
