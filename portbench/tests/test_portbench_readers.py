"""The readers of the program's spans and counters on synthetic runs: the
mean over the calls that carry the key, in the metric's unit, and None
where no call carries it (a program without the span or counter)."""

import pytest

from portbench import harness

#: metric -> (the breakdown key it reads, its scale to the metric's unit)
READS = {
    "setup.geometry_ms": ("align.geometry", 1e3),
    "setup.live_blocks_ms": ("sparse_blocks", 1e3),
    "loop.span_ms": ("align.loop", 1e3),
    "writeback.ms": ("align.writeback", 1e3),
    "align.unspanned_ms": ("align.unspanned", 1e3),
    "host.syncs": ("host_syncs", 1),
}


def _run(breakdowns):
    return harness.Run(cell=None, device="cpu", calls=[
        dict(wall=0.1, setup_s=0.05, breakdown=b) for b in breakdowns])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_takes_the_mean_over_the_calls_that_carry_its_key(name):
    key, scale = READS[name]
    got = harness.reader(name)(_run([{key: 2}, {key: 4}, {"other": 1.0}]))
    assert got == pytest.approx(3 * scale)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_finds_nothing_without_its_key(name):
    read = harness.reader(name)
    assert read(_run([{"catalog": 0.01}, {}])) is None
    assert read(_run([])) is None
