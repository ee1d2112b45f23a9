"""Device time by program span (`bench/program_spans.py`) and its five
readers: the attribution on made-up traces (by launch, innermost span,
inclusive up the tree, idle gaps by the host's innermost span, no link
through the number 0), a traced run on the CPU that still prints its line
with none of the five metrics, and on the card each cell's line with the
five in their cells."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

from bench import program_spans as ps
from bench import run
from bench.spec import load_cell

CPU = torch.device("cpu")
NEW = {"lookup_device_ms": ("cat1m.bulk", "ml1m.bulk"),
       "scan_device_ms": ("cat1m.bulk", "ml1m.bulk"),
       "rank_device_ms": ("cat1m.bulk", "ml1m.bulk"),
       "prune_bounds_device_ms": ("cat1m.bulk",),
       "dense_select_device_ms": ("ml1m.bulk",)}
MAIN, OTHER = 7, 8  # host threads


def _host(corr, name, start, end, thread=MAIN):
    return ps.HostRange(corr, name, start, end, thread)


def _trace(with_spans=True):
    """One window (0-1000 ns) holding two batches: `bench.stage` launches a
    copy, `serve` its stages; the scan stage's bounds launch one kernel
    straight from the span, its sort from an operator; the first batch's
    rank kernel is linked to no host range, only to its launch, whose
    number an operator of the stage span has too (host ranges and launches
    are numbered apart, as in a trace); the second batch's launch links to
    an operator."""
    hosts = [_host(1, "bench.window", 0, 1000)]
    ops, launches = [], {}
    corr = 100
    for b, t in enumerate((0, 500)):
        spans = [("bench.stage", t, t + 10), ("bench.serve", t + 10,
                                              t + 300),
                 ("serve", t + 20, t + 290), ("serve.lookup", t + 30, t + 60),
                 ("serve.scan", t + 60, t + 200),
                 ("nns.stream", t + 70, t + 190),
                 ("nns.stream.bounds", t + 80, t + 100),
                 ("serve.rank", t + 200, t + 280)]
        if not with_spans:
            spans = [s for s in spans if s[0].startswith("bench.")]
        for name, a, z in spans:
            corr += 1
            hosts.append(_host(corr, name, a, z))
        # (launched in an operator at, device start, device end)
        for at, d0, d1, how in ((t + 5, t + 40, t + 50, "op"),
                                (t + 40, t + 50, t + 80, "op"),
                                (t + 85, t + 100, t + 130, "span"),
                                (t + 110, t + 130, t + 230, "op"),
                                (t + 210, t + 230, t + 260,
                                 "launch" if b == 0 else "op+launch")):
            corr += 1
            if how == "span":  # the innermost open range is the span
                linked = next(h.corr for h in hosts[::-1] if h.start < at
                              < h.end)
            elif how == "launch":  # an operator elsewhere has its number
                hosts.append(_host(corr, "aten::op", t + 6, t + 7))
                launches[corr] = ps.Launch(0, at, MAIN)
                linked = 0
            elif how == "op+launch":  # the launch links to the operator
                hosts.append(_host(corr + 1000, "aten::op", at, at + 1))
                launches[corr] = ps.Launch(corr + 1000, at, MAIN)
                linked = 0
            else:
                hosts.append(_host(corr, "aten::op", at, at + 1))
                linked = corr
            ops.append(ps.DeviceOp("void k<int>(int)", d0, d1, corr,
                                   linked))
    return hosts, launches, ops


def test_device_time_goes_to_the_innermost_span_at_launch():
    t = ps.attribute(*_trace())
    assert t.batches == 2
    per = {k: v * 1e9 / 2 for k, v in t.inclusive_s.items()}  # ns a batch
    assert per == pytest.approx({
        "bench.window": 10 + 30 + 30 + 100 + 30,
        "bench.stage": 10, "bench.serve": 190, "serve": 190,
        "serve.lookup": 30, "serve.scan": 130, "nns.stream": 130,
        "nns.stream.bounds": 30, "serve.rank": 30})
    assert t.busy_s * 1e9 == pytest.approx(2 * 200)
    assert t.outside_s * 1e9 == pytest.approx(2 * 10)
    assert t.unlinked_s == 0
    assert t.exclusive_s["nns.stream"] * 1e9 == pytest.approx(2 * 100)
    assert t.device_ms("serve.scan") == pytest.approx(130e-6)
    assert t.device_ms("nns.dense.select") is None
    # idle: the window less the busy time; 10 ns of each batch's stage
    # span, and 200 ns after each batch's `bench.serve` span, when the host
    # is in the loop's own code
    idle = {k: v * 1e9 for k, v in t.idle_by_span.items()}
    assert sum(idle.values()) == pytest.approx(1000 - 2 * 200)
    assert idle["bench.stage"] == pytest.approx(2 * 10)
    assert idle["bench.loop"] == pytest.approx(2 * 200)


def test_overlap_on_the_device_plays_no_part():
    """The same operations run late, under the next batch's host spans:
    the time stays where they were launched."""
    hosts, launches, ops = _trace()
    late = [ps.DeviceOp(o.name, o.start + 240, o.end + 240, o.corr,
                        o.linked) for o in ops[:5]]
    t = ps.attribute(hosts, launches, late)
    assert t.inclusive_s["serve.scan"] * 1e9 == pytest.approx(130)


def test_a_program_without_spans_yields_no_time():
    t = ps.attribute(*_trace(with_spans=False))
    assert t.batches == 0 and t.busy_s > 0
    assert t.outside_s == pytest.approx(t.busy_s)
    for name in ("serve.lookup", "serve.scan", "serve.rank",
                 "nns.stream.bounds", "nns.dense.select"):
        assert t.device_ms(name) is None
    assert ps.attribute([], {}, []).device_ms("serve") is None


def test_a_host_range_numbered_0_takes_no_launch():
    """The port's ctypes kernels link to no host range (0), nor do their
    launches: a host range that itself has the number 0 (a profiler's
    own overhead, say) must not take them."""
    hosts, launches, ops = _trace()
    hosts.append(_host(0, "profiler overhead", 0, 1000))
    t = ps.attribute(hosts, launches, ops)
    assert t.inclusive_s == ps.attribute(*_trace()).inclusive_s
    assert t.inclusive_s["serve.rank"] * 1e9 == pytest.approx(2 * 30)


def test_spans_on_another_thread_do_not_nest():
    hosts, launches, ops = _trace()
    hosts.append(_host(999, "serve.rank", 0, 1000, thread=OTHER))
    t = ps.attribute(hosts, launches, ops)
    assert t.inclusive_s["serve.rank"] * 1e9 == pytest.approx(2 * 30)


@pytest.mark.parametrize("workload", ["ml1m.bulk", "cat1m.bulk"])
def test_traced_line_on_the_cpu_has_none_of_the_new_metrics(tiny, capsys,
                                                            workload):
    cell = load_cell(tiny, workload)
    assert {m["name"] for m in cell.per_layer} >= {
        n for n, cells in NEW.items() if workload in cells}
    out = run.run_cell(cell, 2**31 + 23, 1.0, True, CPU)
    run.print_line(out)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["correct"] is True, captured.err[-2000:]
    assert not set(line["metrics"]) & set(NEW)
    assert "program spans: no device time" in captured.err


@pytest.mark.cuda
def test_cells_report_the_span_metrics_on_the_card(cuda_device):
    for w in ("ml1m.bulk", "cat1m.bulk"):
        proc = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", w, "--seed",
             str(2**31 + 29), "--seconds", "2", "--trace", "1"],
            capture_output=True, text=True, timeout=600, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        assert line["correct"] is True
        want = {n for n, cells in NEW.items() if w in cells}
        assert want <= set(line["metrics"]), proc.stderr[-3000:]
        assert all(line["metrics"][n]["value"] > 0 for n in want)
