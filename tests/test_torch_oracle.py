"""The shared-oracle helper (tests/torch_oracle.py): a job that dies of
a signal fails at once unless it asked for retries, each retry is
reported, and a failed job is not run again by the next worker."""

import os
import signal

import pytest

from torch_oracle import both_sides, shared


def _die_first(out, marker):
    """Dies of SIGSEGV on its first call (marker not yet written), then
    returns 7."""
    if not os.path.exists(marker):
        open(marker, "w").close()
        os.kill(os.getpid(), signal.SIGSEGV)
    return 7


def _side(out, side, x):
    return side, x


@pytest.mark.parametrize("retries", [0, 1])
def test_signal_death_retried_only_when_asked(tmp_path, tmp_path_factory,
                                              retries):
    name = f"oracle_selftest_{retries}"
    marker = str(tmp_path / "ran")
    if retries == 0:
        with pytest.raises(RuntimeError, match="died of SIGSEGV"):
            shared(tmp_path_factory, name, _die_first, marker)
        # a second caller gets the same failure and does not rerun it
        with pytest.raises(RuntimeError, match="died of SIGSEGV"):
            shared(tmp_path_factory, name, _die_first, marker)
    else:
        with pytest.warns(UserWarning, match=f"{name} died of SIGSEGV"):
            assert shared(tmp_path_factory, name, _die_first, marker,
                          retries=retries) == 7


def test_both_sides(tmp_path_factory):
    assert both_sides(tmp_path_factory, "oracle_selftest_sides", _side,
                      3) == [("jax", 3), ("torch", 3)]
