"""The program's spans read from a run of the harness (``portbench/spans.py``):
the idle-gap naming rules on spans laid out by hand, and a traced tiny
pretraining run on the CPU under a recorder, whose loader, trainer and
block-step spans are there and whose result line is the accepted one."""

from __future__ import annotations

import io
import json
from contextlib import redirect_stderr, redirect_stdout

from portbench import spans
from portbench.tests.test_portbench_harness import PRETRAIN, SEED, root  # noqa: F401
from vln_bevbert_tpu_torch.utils.profiling import Span

#: what a traced CPU run of the tiny pretraining cell reads: the harness's
#: host spans (the device's metrics need the card)
HOST_METRICS = {"loader_ms_per_step.pretrain", "dispatch_host_ms_per_step.pretrain"}


def _span(id, name, start, end, parent=None, thread="MainThread"):
    return Span(id, name, start, end, 0, thread, parent, None)


def test_a_gap_is_named_by_the_longest_own_overlap_and_by_the_names_summed():
    # a block holding three waits and a dispatch; the gap [100, 400) meets
    # the block's own time (150 ns in all: 100-150, 200-250, 300-350) and
    # three waits of 50 ns each; another thread's span does not count
    layout = [_span(0, "trainer.block", 0, 1000),
              _span(1, "loader.wait", 150, 200, parent=0),
              _span(2, "loader.wait", 250, 300, parent=0),
              _span(3, "loader.wait", 350, 400, parent=0),
              _span(4, "block_step", 400, 600, parent=0),
              _span(5, "loader.build", 0, 1000, thread="loader-prefetch")]
    named = spans.name_gap(100, 400, layout, "MainThread")
    assert named["span"] == "trainer.block"  # its 150 ns against each wait's 50
    assert named["name"] == "trainer.block"  # 150 against 150: the first met
    assert named["shares"] == {"trainer.block": 0.5, "loader.wait": 0.5}
    layout[1] = _span(1, "loader.wait", 120, 200, parent=0)
    named = spans.name_gap(100, 400, layout, "MainThread")
    assert (named["span"], named["name"]) == ("trainer.block", "loader.wait")
    assert spans.name_gap(2000, 3000, layout, "MainThread")["span"] == "no host span"


def test_a_traced_run_under_the_recorder_reads_the_programs_spans(root, tmp_path):  # noqa: F811
    out, err = io.StringIO(), io.StringIO()
    report_file = tmp_path / "spans.json"
    with redirect_stdout(out), redirect_stderr(err):
        rc = spans.main(["--workload", PRETRAIN, "--seed", str(SEED), "--seconds", "0.5",
                         "--trace", "1", "--out", str(report_file)],
                        root=root, need_card=False, device_name="cpu")
    assert rc == 0, err.getvalue()[-3000:]
    line, report = (json.loads(x) for x in out.getvalue().strip().splitlines()[-2:])
    assert line["correct"] and set(line["metrics"]) == HOST_METRICS
    assert json.loads(report_file.read_text()) == report
    w = report["window"]
    assert w["steps"] == line["attempted"] > 0
    for key in ("loader_wait_ms_per_step", "block_step_ms_per_step",
                "trainer_block_self_ms_per_step", "loader_build_ms_per_call",
                "loader_items_ms_per_call", "loader_collate_ms_per_call"):
        assert w[key] > 0, key
    assert w["loader_items_ms_per_call"] + w["loader_collate_ms_per_call"] \
        <= w["loader_build_ms_per_call"]
    # one build a batch: the steps trained, and at most the prefetch queue's
    # two and one in the making besides
    assert w["steps"] <= w["calls"]["loader.build"] <= w["steps"] + 3
    # no card: no graphs, no device phases, no trace of the device
    assert w["graph_captures"] == 0 and w["device_ms_per_step"] == {}
    assert "traced" not in report and "stage_ms_per_step" not in w
