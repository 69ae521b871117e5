"""``RESPECT_DECODE_IMPL`` chooses the decode in both packages (ROADMAP
fault C2, closed): with no explicit ``decode_impl`` a ``BucketedDecoder`` —
and so ``RespectScheduler`` and ``SchedulerService`` — takes the variable's
value; an explicit argument wins; an empty value counts as unset.  The
reference's ``"kernel-interpret"`` (a Pallas interpret mode) has no port
value and raises ``ValueError`` in the port, as an unknown value does in
both."""

import numpy as np
import pytest

from repro.core import batching as jbatching
from repro_torch.core import RespectScheduler, sample_dag
from repro_torch.core import batching as tbatching

ENV = "RESPECT_DECODE_IMPL"


def test_env_name_matches_reference():
    assert tbatching.DECODE_IMPL_ENV == jbatching.DECODE_IMPL_ENV == ENV


@pytest.mark.parametrize("value", ["scan", "kernel"])
def test_env_value_is_taken_in_both(monkeypatch, value):
    monkeypatch.setenv(ENV, value)
    assert jbatching.BucketedDecoder().decode_impl == value
    dec = tbatching.BucketedDecoder("cpu")
    assert dec.decode_impl == value
    assert dec.resolve_decode_impl(32, 128) == value
    assert RespectScheduler.init(seed=0, hidden=32, device="cpu")._decoder.decode_impl == value


def test_explicit_argument_wins(monkeypatch):
    monkeypatch.setenv(ENV, "scan")
    assert jbatching.BucketedDecoder(decode_impl="kernel").decode_impl == "kernel"
    assert tbatching.BucketedDecoder("cpu", decode_impl="kernel").decode_impl == "kernel"
    monkeypatch.setenv(ENV, "bogus")
    assert tbatching.BucketedDecoder("cpu", decode_impl="scan").decode_impl == "scan"


def test_unset_or_empty_is_auto(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert tbatching.BucketedDecoder("cpu").decode_impl is None
    assert tbatching.BucketedDecoder("cpu").resolve_decode_impl(32, 128) == "kernel"
    monkeypatch.setenv(ENV, "")
    assert jbatching.BucketedDecoder().decode_impl is None
    assert tbatching.BucketedDecoder("cpu").decode_impl is None


@pytest.mark.parametrize("value", ["kernel-interpret", "bogus"])
def test_unknown_values_raise_in_the_port(monkeypatch, value):
    monkeypatch.setenv(ENV, value)
    with pytest.raises(ValueError, match="decode_impl"):
        tbatching.BucketedDecoder("cpu")
    with pytest.raises(ValueError, match="decode_impl"):
        RespectScheduler.init(seed=0, hidden=32, device="cpu")
    if value == "bogus":
        with pytest.raises(ValueError, match="decode_impl"):
            jbatching.BucketedDecoder()
    else:         # the reference's Pallas interpret mode
        assert jbatching.BucketedDecoder().decode_impl == value


def test_forced_scan_schedules_as_the_default(monkeypatch):
    rng = np.random.default_rng(0)
    graphs = [sample_dag(rng, n=int(rng.integers(6, 30)), deg=3) for _ in range(6)]
    want = RespectScheduler.init(seed=0, hidden=32, device="cpu").schedule_many(graphs, 4)
    monkeypatch.setenv(ENV, "scan")
    got = RespectScheduler.init(seed=0, hidden=32, device="cpu").schedule_many(graphs, 4)
    for r, w in zip(got, want):
        assert np.array_equal(r["order"], w["order"])
        assert np.array_equal(r["assignment"], w["assignment"])
