"""Every case of tests/test_suite_faunadb.py (the query builder and the
HTTP client against tests/fake_fauna.py, temporal reads, aborts, index
pagination, error classification, the read-skew, timestamp-order and
monotonic checkers, the topology state machine, every workload through
a hermetic core.run, with the topology and partition nemeses, the
workload menu, the test-all sweep and the plotter) run on the port's
faunadb suite.

The suite's register workload's independent checker checks on CUDA
unless the opts name a device; an autouse fixture fills in
device="cpu" when the opts given to `faunadb_test` name none."""

import pytest

import torch_mirror
from jepsen_tpu_torch.suites import faunadb

globals().update(torch_mirror.cases("test_suite_faunadb"))


@pytest.fixture(autouse=True)
def _checkers_on_the_cpu(monkeypatch):
    torch_mirror.on_cpu(monkeypatch, faunadb, "faunadb_test")


def test_timestamp_value_checker_flags_an_inc_tied_with_an_earlier_read():
    """`test_e2e_monotonic`'s rare red, in both packages: its jitter
    draws a read-at timestamp from the unseeded module `random`, and the
    fake's counter timestamps make a read-at at an inc's own timestamp
    likely. The inc returns the value before its write, the read sees
    the write, and the checker orders the two by history position at
    equal timestamps, so a read that completed first reads as a decrease.
    Both packages' checkers flag the same pair."""
    from jepsen_tpu.suites import faunadb as jfaunadb
    hist = [{"type": "ok", "f": "inc", "value": ["0000000000000000492", 125],
             "process": 1, "index": 0},
            {"type": "ok", "f": "read-at",
             "value": ["0000000000000000493", 127], "process": 2, "index": 1},
            {"type": "ok", "f": "inc", "value": ["0000000000000000493", 126],
             "process": 0, "index": 2}]
    got = faunadb.TimestampValueChecker().check({}, hist, {})
    assert got == jfaunadb.TimestampValueChecker().check({}, hist, {})
    assert got["valid?"] is False and got["errors"] == [hist[1:]]
    # the same ops with the read completing after the inc: valid
    late = [hist[0], hist[2], dict(hist[1], index=3)]
    assert faunadb.TimestampValueChecker().check({}, late, {})["valid?"]
