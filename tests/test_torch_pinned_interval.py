"""The fleet whose batch interval is pinned (``tunebench/configs/
pinned_fleet1024.json``): every engine runs at 0.5 s ticks and
``batch_interval_s`` is not a lever, so the fused loop's tick budget is
read from the packed configs (the untuned branch of
``DeviceEpisodeRunner._tick_budget``) and every window runs 1024 ticks.

* the port's first three updates on a cut copy of the configuration
  (8 clusters, the configuration's own 240 s windows) against the plain
  reference (``tunebench/reference/tuner_ref.py``), through the
  benchmark's own entry;
* both branches of the tick budget and their counters
  (``PROLOGUE_COUNTS``: ``tick_packed`` beside ``tick_pack_skipped``);
* the ``rt.epoch.tick_budget`` span under the CPU profiler, and the
  benchmark's reader of it;
* the launch shapes the benchmark's cell computes: T, S, K = 1024, 8, 120.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from repro_torch.core.device_loop import PROLOGUE_COUNTS  # noqa: E402
from tunebench import run as R  # noqa: E402
from tunebench.harness import correct as C  # noqa: E402
from tunebench.harness.bench import Cell  # noqa: E402
from tunebench.harness.inputs import make_inputs  # noqa: E402
from tunebench.harness.system import build  # noqa: E402
from tunebench.harness.trace import Trace  # noqa: E402

PINNED = "pinned_fleet1024.epoch"
CLAMPED = "paper_fleet1024.epoch"
#: clusters of the CPU runs
N = 8
SEED = 2 ** 31 + 5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cell_name: str) -> Cell:
    cell = Cell(cell_name, ROOT)
    cell.config["clusters"] = N
    return cell


def _built(cell: Cell):
    inputs = make_inputs(cell.config, cell.traffic, SEED, "cpu")
    return inputs, build(cell.config, cell.traffic, inputs, "cpu")


def _delta(before: dict) -> dict:
    return {k: PROLOGUE_COUNTS[k] - v for k, v in before.items()}


def test_pinned_fleet_equals_the_reference_on_the_cpu():
    """On the CPU the kernels run their plain versions and the programs
    run eagerly, so the reference takes the same steps bit for bit. The
    first gradient is read back from rmsprop's state as
    ``sqrt(nu / (1 - decay))`` on the program's side, which rounds: its gap
    is held under 1e-7 with ``nu`` itself bitwise equal."""
    cell = _cut(PINNED)
    assert "batch_interval_s" not in cell.config["tuning"]["levers"]
    inputs, cfgr = _built(cell)
    assert {c["batch_interval_s"] for c in cfgr.env.configs} == {0.5}
    prog = C.to_host(C.program_first_updates(cfgr, cell.traffic))
    assert cfgr._device_runner()._hw_T == 1024
    ref = C.reference_first_updates(cell.config, cell.traffic, inputs, "cpu")
    assert prog["losses"] == ref["losses"]
    for k in ref["params"]:
        assert torch.equal(prog["params"][k], ref["params"][k]), k
        assert torch.equal(prog["nu1"][k], ref["nu1"][k]), k
    gaps = C.compare(prog, ref, cell.config)
    assert gaps["loss_gap"] == 0.0 and gaps["change_gap"] == 0.0
    assert gaps["grad1_gap"] < 1e-7


def test_tick_budget_branches_and_their_counters():
    """Pinned: T from the configs' 0.5 s ticks (480 window ticks, 360 of
    stabilisation and one, on the ladder: 1024), ``tick_packed`` +1 a call.
    Tuned: clamped to 192 ticks, ``tick_pack_skipped`` +1 a call and
    ``tick_packed`` unchanged. Over ``run_epoch`` the pinned fleet packs once
    a segment (one segment for the warm-up update, then one each side of
    the exploit boundary)."""
    _, cfgr = _built(_cut(PINNED))
    runner = cfgr._device_runner()
    before = dict(PROLOGUE_COUNTS)
    for _ in range(2):
        cfgr.env.invalidate()
        assert runner._tick_budget() == (1024, 6)
    assert _delta(before) == {"support_checked": 0, "support_reused": 0,
                              "tick_pack_skipped": 0, "tick_packed": 2}

    _, clamped = _built(_cut(CLAMPED))
    before = dict(PROLOGUE_COUNTS)
    assert clamped._device_runner()._tick_budget() == (192, 6)
    assert clamped.env._packed is None
    assert _delta(before) == {"support_checked": 0, "support_reused": 0,
                              "tick_pack_skipped": 1, "tick_packed": 0}

    before = dict(PROLOGUE_COUNTS)
    cfgr.run_epoch(1, records="summary")
    cfgr.run_epoch(2, records="summary")
    assert _delta(before)["tick_packed"] == 3
    assert _delta(before)["tick_pack_skipped"] == 0


def _spans(prof) -> list:
    """The ``rt.`` spans of a profile as (name, parent name), the parent
    the innermost ``rt.`` span that holds it (None: none)."""
    rows = sorted(((e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rt.")), key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, s, e in rows:
        while stack and stack[-1][2] < e:
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, s, e))
    return out


def test_tick_budget_span_under_the_cpu_profiler():
    """One ``rt.epoch.tick_budget`` a segment, inside ``rt.epoch.program``,
    holding no other span."""
    _, cfgr = _built(_cut(PINNED))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfgr.run_epoch(1, records="summary")
    spans = _spans(prof)
    budget = [up for name, up in spans if name == "rt.epoch.tick_budget"]
    assert budget == ["rt.epoch.program"]
    assert all(up != "rt.epoch.tick_budget" for _, up in spans)


def test_tick_budget_reader_on_a_known_trace():
    """``tick_budget_host_ms_per_chunk``: the span's host ms over the
    chunks, and None where the program has no such span (the parent
    commit's program, or no profiled chunk)."""
    read = Cell(PINNED, ROOT).reader("tick_budget_host_ms_per_chunk")
    host = [("rt.epoch.tick_budget", 0, 7_000_000),
            ("rt.epoch.tick_budget", 9_000_000, 5_000_000),
            ("rt.epoch.program", 0, 20_000_000)]
    trace = Trace(device=[], host=host, start_ns=0, end_ns=30_000_000,
                  updates=16, chunks=2)
    assert read(trace) == 6.0
    trace.host = host[2:]
    assert read(trace) is None


def test_pinned_cell_launches_the_long_window():
    """The cell's windows at the full configuration (clusters cut to 8 for
    the inputs alone): the untuned budget's T = 1024 with 8 lanes and a
    120-deep head, and no fault multiplier."""
    cell = Cell(PINNED, ROOT)
    small = dict(cell.config, clusters=N)
    shapes = R.launch_shapes(cell.config, cell.traffic,
                             make_inputs(small, cell.traffic, 1, "cpu"))
    assert (shapes["T"], shapes["S"], shapes["K"]) == (1024, 8, 120)
    assert shapes["N"] == 1024 and shapes["fmult"] is False
    assert shapes["steps"] == 5
