"""The attribution of a traced window's device rows to the program's spans
(``harness/spans.py``) and the readers on it, on synthetic traces: exact
when the expected rows equal the device rows, None when one is missing or
extra, and None on a program that records no spans.

    python -m pytest -q tunebench/tests
"""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from repro_torch.monitoring.tracing import SpanTable  # noqa: E402

from tunebench.harness import spans  # noqa: E402
from tunebench.harness.bench import Cell  # noqa: E402
from tunebench.harness.trace import Trace  # noqa: E402

US = 1_000

#: a body of 8 device nodes: 1 at the root, encode 1, act 2 of which the
#: shield's mask 1, the window 3 (the fault grid 1, the kernel 1, the
#: summary 1), the update 1
TABLE = SpanTable(
    program=7,
    names=("rt.program#7", "rt.step.encode", "rt.step.act", "rt.shield",
           "rt.step.window", "rt.window.faults", "rt.window.core",
           "rt.update"),
    parents=(-1, 0, 0, 2, 0, 4, 4, 0),
    enter=(0, 1, 2, 3, 4, 4, 5, 7),
    exit=(8, 2, 4, 4, 7, 5, 6, 8))
#: the device names of the body's rows, in node order
BODY = ("copy", "encode", "act", "mask", "fault", "fleet_tick_warp_kernel",
        "summary", "rmsprop")


def _trace(missing: int = 0, extra: int = 0) -> Trace:
    """Two chunks of one update each: a load copy under ``rt.epoch.load``,
    the body's graph launched under ``rt.replay#7``, an output clone under
    ``rt.epoch.outputs``; each device row 1 us plus its node index, so a
    row put down to the wrong part changes its sums."""
    host, device = [], []
    t = 0
    for _ in range(2):
        host += [("rt.epoch.load", t, 50 * US), ("cudaMemcpyAsync", t + US,
                                                  2 * US)]
        device.append(("Memcpy HtoD", t + 10 * US, 3 * US))
        t += 100 * US
        host += [("rt.replay#7", t, 20 * US),
                 ("cudaGraphLaunch", t + US, 15 * US)]
        for j, name in enumerate(BODY):
            device.append((name, t + 30 * US + 10 * j * US, (1 + j) * US))
        t += 200 * US
        host += [("rt.epoch.outputs", t, 10 * US),
                 ("cudaLaunchKernel", t + US, 2 * US),
                 ("rt.epoch.summary", t + 20 * US, 30 * US)]
        device.append(("clone", t + 5 * US, 4 * US))
        t += 100 * US
    device = device[:len(device) - missing]
    device += [("stray", t + 10 * US * i, US) for i in range(extra)]
    return Trace(device=device, host=host, start_ns=0, end_ns=t, updates=2,
                 chunks=2, shapes={}, untraced_s=0.0)


def test_attribution_is_exact_when_the_counts_match(capsys):
    att = spans.attribute(_trace(), {7: TABLE})
    assert "20 device rows expected (2 graph launches, 4 other launch " \
        "calls), 20 found" in capsys.readouterr().err
    # node j lasts (1 + j) us, twice
    us = lambda *nodes: 2 * sum(1 + j for j in nodes) * US
    assert att.graph_ns == {"root": us(0), "step_control": us(1, 2),
                            "shield": us(3), "fault_grid": us(4),
                            "window_kernel": us(5), "window_step": us(6),
                            "policy_update": us(7)}
    assert sum(att.graph_rows.values()) == 16
    assert att.eager_ns == {"rt.epoch.load": 6 * US,
                            "rt.epoch.outputs": 8 * US}
    assert att.eager_rows == {"rt.epoch.load": 2, "rt.epoch.outputs": 2}


@pytest.mark.parametrize("missing,extra", [(1, 0), (0, 1)],
                         ids=["a-row-missing", "a-row-extra"])
def test_no_attribution_when_a_row_is_missing_or_extra(missing, extra,
                                                      capsys):
    assert spans.attribute(_trace(missing, extra), {7: TABLE}) is None
    err = capsys.readouterr().err
    assert "20 device rows expected" in err
    assert f"{20 - missing + extra} found: no attribution" in err


def test_no_attribution_without_the_graph_table():
    assert spans.attribute(_trace(), {}) is None


def test_readers_on_the_attribution(monkeypatch):
    monkeypatch.setattr("repro_torch.monitoring.tracing.TABLES", {7: TABLE})
    c = Cell("chaos_fleet1024.epoch_shielded", ROOT)
    tr = _trace()
    # ms an update: 2 updates; node j lasts (1 + j) us in each
    want = {"window_step_device_ms_per_update": 7e-3,
            "step_control_device_ms_per_update": 5e-3,
            "policy_update_device_ms_per_update": 8e-3,
            "fault_grid_device_ms_per_update": 5e-3,
            "shield_device_ms_per_update": 4e-3,
            # one 20 us replay an update; load 50 + summary 30 us a chunk
            "graph_launch_host_ms_per_update": 20e-3,
            "epoch_boundary_host_ms_per_chunk": 80e-3}
    for name, value in want.items():
        assert c.reader(name)(tr) == pytest.approx(value), name
    # a trace without the program's spans: every new reader reads None
    bare = Trace(device=tr.device, host=[r for r in tr.host
                                          if not r[0].startswith("rt.")],
                 start_ns=0, end_ns=tr.end_ns, updates=2, chunks=2,
                 shapes={}, untraced_s=0.0)
    for name in want:
        assert c.reader(name)(bare) is None, name
