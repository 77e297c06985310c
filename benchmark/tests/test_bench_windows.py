"""The reader of the port's counter "slice.windows" (benchmark/metrics/
device_windows_per_chunk.py) on the CPU: a stand-in recorder, a program
without the counter, and the tiny one-card cells traced.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import sys
import types

import pytest

from benchmark import harness, program_spans
from benchmark.tests.tiny import run_tiny

NAME = "device_windows_per_chunk"
READ = harness.load_module("metrics", NAME).read


def _port(counters):
    return types.SimpleNamespace(records=lambda: [], counters=lambda: dict(counters))


def test_the_reader_is_windows_over_chunks(monkeypatch):
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE,
                        _port({"slice.windows": 1128, "chunks": 282}))
    assert READ({}) == pytest.approx(4.0)


@pytest.mark.parametrize("counters", [None, {"chunks": 282}, {"slice.windows": 3}])
def test_a_program_without_the_counter_reads_nothing(monkeypatch, counters):
    """The parent commit's port keeps no "slice.windows" (or no recorder):
    the reader returns None and does not raise."""
    monkeypatch.setitem(sys.modules, program_spans.PORT_TRACE,
                        None if counters is None else _port(counters))
    assert READ({}) is None


@pytest.mark.parametrize("name,want", [("toccata.offline", 4.0),
                                       ("nice_voices.texture_4096", 2.0),
                                       ("nice_voices.live_fleet", None)])
def test_each_tiny_cell_traced_reads_its_windows(name, want):
    from zang_tpu_torch import trace

    trace.reset_counters()  # the counters are the process's: this run's alone
    correct, line, _ = run_tiny(name, trace=True)
    assert correct, line
    got = json.loads(line)["metrics"].get(NAME)
    listed = next(m for m in harness.manifest()["per_layer"] if m["name"] == NAME)
    if want is None:
        assert got is None and name not in listed["workloads"]
    else:
        assert name in listed["workloads"] and got["value"] == pytest.approx(want)
