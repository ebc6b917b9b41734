import os
import sys

import pytest

# tests see 1 CPU device (the dry-run sets its own 512-device flag in
# subprocesses; never globally — see launch/dryrun.py)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


# --------------------------------------------------------------------------
# Optional-dependency stand-ins: the container may lack `hypothesis`.
# Property-test modules fall back to these so ONLY the property tests skip
# (the seed behavior was an import error that killed whole files).
# --------------------------------------------------------------------------
def given(*_args, **_kwargs):
    def deco(fn):
        def stub():
            pytest.skip("hypothesis not installed")
        stub.__name__ = fn.__name__
        stub.__doc__ = fn.__doc__
        return stub
    return deco


def settings(*_args, **_kwargs):
    return lambda fn: fn


class st:  # noqa: N801 — mirrors `hypothesis.strategies as st`
    @staticmethod
    def integers(*_a, **_k):
        return None

    @staticmethod
    def floats(*_a, **_k):
        return None

    @staticmethod
    def sampled_from(*_a, **_k):
        return None


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); each such "
        "test skips itself where torch sees none")
