"""The port's span recorder (``utils/profiling.py``) on the CPU: the null
context without a recorder, nesting with parents, threads, keys and self
time, totals past the bound on kept spans, spans closed by exceptions and
silent inside a capture, recordings that do not nest, device phases that do
nothing without a card, and the spans a tiny blocked ``PretrainTrainer``
and its prefetching loader record. The card's stamps are tested in
``tests/test_torch_cuda.py``."""

import json
import threading
import time

import pytest
import torch

from test_torch_pretrain import SHAPES
from vln_bevbert_tpu_torch import _build
from vln_bevbert_tpu_torch.cli import pretrain as cli
from vln_bevbert_tpu_torch.utils import graphs, profiling

BLOCK, STEPS = 4, 11


def test_span_without_a_recorder_is_one_null_context_and_keeps_nothing():
    assert profiling.span("a") is profiling.span("b", key=3) is profiling._NULL
    with profiling.span("a"):
        pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.totals == {}
    assert profiling.span("a") is profiling._NULL  # uninstalled on exit


def test_spans_nest_with_parent_thread_key_and_self_time(monkeypatch):
    clock = iter(range(0, 10 ** 6, 10))  # every read 10 ns after the last
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))
    with profiling.recording() as rec:
        with profiling.span("outer", key=7):
            with profiling.span("inner", key=8):
                pass
            with profiling.span("inner"):
                with profiling.span("leaf"):
                    pass

        def other():
            with profiling.span("elsewhere"):
                pass

        t = threading.Thread(target=other, name="other-thread")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    by_name = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    (outer,), (first, second), (leaf,), (elsewhere,) = (
        by_name[n] for n in ("outer", "inner", "leaf", "elsewhere"))
    assert outer.parent is None and outer.key == 7
    assert first.parent == second.parent == outer.id and first.key == 8 and second.key is None
    assert leaf.parent == second.id
    assert {s.thread for s in (outer, first, second, leaf)} == {"MainThread"}
    assert elsewhere.thread == "other-thread" and elsewhere.parent is None
    # closed in order: children first
    assert [s.name for s in rec.spans[:4]] == ["inner", "leaf", "inner", "outer"]
    assert first.end_ns - first.start_ns == first.self_ns == 10
    assert leaf.self_ns == 10 and second.end_ns - second.start_ns == 30 and second.self_ns == 20
    assert outer.end_ns - outer.start_ns == 70 and outer.self_ns == 70 - 10 - 30
    assert rec.totals["inner"].count == 2
    assert rec.totals["inner"].seconds == pytest.approx(40e-9)
    assert rec.totals["outer"].self_seconds == pytest.approx(30e-9)


def test_totals_stay_exact_past_the_bound_on_kept_spans(monkeypatch):
    clock = iter(range(0, 10 ** 6, 5))
    monkeypatch.setattr(profiling.time, "time_ns", lambda: next(clock))
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording() as rec:
        for i in range(10):
            with profiling.span("step", key=i):
                with profiling.span("part"):
                    pass
    assert len(rec.spans) == 3 and rec.dropped == 17
    assert [(s.name, s.key) for s in rec.spans] == [("part", None), ("step", 0), ("part", None)]
    assert rec.totals["step"].count == rec.totals["part"].count == 10
    assert rec.totals["step"].seconds == pytest.approx(10 * 15e-9)
    assert rec.totals["step"].self_seconds == pytest.approx(10 * 10e-9)
    assert rec.totals["part"].seconds == pytest.approx(10 * 5e-9)
    rec.clear()
    assert rec.spans == [] and rec.totals == {} and rec.dropped == 0


def test_a_span_closes_when_an_exception_leaves_it():
    with profiling.recording() as rec:
        with pytest.raises(KeyError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise KeyError("x")
        with profiling.span("after"):
            pass
    inner, outer, after = rec.spans
    assert (inner.name, outer.name) == ("inner", "outer") and inner.parent == outer.id
    assert after.parent is None  # the stack was unwound
    assert rec._stack() == []


def test_recordings_do_not_nest_and_captures_record_nothing(monkeypatch):
    with profiling.recording() as rec:
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.recording():
                pass
        # the thread that queues a graph's capture
        monkeypatch.setattr(graphs, "_CAPTURING", object())
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
        assert profiling.span("captured") is profiling._NULL
        # another thread's stream is not capturing
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
        with profiling.span("loader"):
            pass
    assert [s.name for s in rec.spans] == ["loader"]


def test_trace_shows_spans_with_and_without_a_recorder(tmp_path):
    with profiling.trace(str(tmp_path / "a")) as prof:
        with profiling.span("bare"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "bare" for e in prof.key_averages())
    assert profiling.span("x") is profiling._NULL  # trace put back what it found
    with profiling.recording() as rec:
        with profiling.trace(str(tmp_path / "b")) as prof:
            with profiling.span("kept", key=1):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert any(e.key == "kept" for e in prof.key_averages())
    assert [(s.name, s.key) for s in rec.spans] == [("kept", 1)]


def test_device_phase_does_nothing_on_the_cpu_and_loads_no_library(monkeypatch):
    def no_build():
        raise AssertionError("the kernels' library was asked for")

    monkeypatch.setattr(_build, "load", no_build)
    profiling.device_phase("step.forward", torch.device("cuda"))  # no recorder
    for device in (None, torch.device("cpu")):
        with profiling.recording(device=device) as rec:
            assert rec.device is None
            profiling.device_phase("step.forward", torch.device("cpu"))
            profiling.device_phase("step.forward", torch.device("cuda"))
            profiling.device_phase(None, torch.device("cpu"))
        assert rec.phases == {} and rec.phase_spans == [] and rec.overflow == 0


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny blocked pretraining run on the CPU (blocks of ``BLOCK``, the
    loader's prefetch thread) under a recorder, and the trainer."""
    tmp = tmp_path_factory.mktemp("profiled")
    config = tmp / "tiny.json"
    config.write_text(json.dumps({
        "model": {"vocab_size": 30522, "hidden_size": 32, "num_attention_heads": 2,
                  "intermediate_size": 64, "num_l_layers": 1, "num_pano_layers": 1,
                  "num_x_layers": 1, "image_feat_size": 24, "bev_grid_feat_size": 20,
                  "bev_dim": 5, "num_sem_classes": 7, "dtype": "float32"},
        "shapes": {**SHAPES.__dict__, "max_txt_len": 64},
        "optim": {"warmup_steps": 4},
        "task_block_size": BLOCK, "log_steps": 1000, "valid_steps": 0,
    }))
    trainer = cli.build(cli.parse_args([
        "--synthetic", "--device", "cpu", "--batch_size", "2", "--seed", "5",
        "--num_steps", str(STEPS), "--tasks", "mlm.1.sap.1", "--config", str(config),
        "--output_dir", str(tmp / "out")]))
    with profiling.recording() as rec:
        trainer.train()
        # the prefetch thread ends its last build once the loop has closed it
        for t in threading.enumerate():
            if t.name == "loader-prefetch":
                t.join(timeout=30)
                assert not t.is_alive()
    return trainer, rec


def test_a_blocked_run_records_each_block_its_wait_padding_dispatch_and_readback(trained):
    trainer, rec = trained
    blocks = rec.named("trainer.block")
    firsts = [s.key for s in blocks]
    assert firsts[0] == 0 and firsts == sorted(firsts) and len(set(firsts)) == len(firsts)
    # each block runs up to BLOCK steps of one task; the next starts where it ended
    lengths = [b - a for a, b in zip(firsts, firsts[1:] + [STEPS])]
    assert all(1 <= n <= BLOCK for n in lengths) and sum(lengths) == STEPS
    assert trainer.state.step == STEPS
    ids = {s.id for s in blocks}
    dispatch = rec.named("block_step")
    assert len(dispatch) == len(blocks) and {s.parent for s in dispatch} == ids
    readback = rec.named("trainer.readback")
    # the first block has no predecessor to read back; the last is read after the loop
    assert len(readback) == len(blocks)
    assert sum(s.parent in ids for s in readback) == len(blocks) - 1
    waits = rec.named("loader.wait")
    # every batch trained was waited for once, inside the block that took it
    assert len(waits) == STEPS and {s.parent for s in waits} <= ids
    assert {s.thread for s in blocks + dispatch + readback + waits} == {"MainThread"}
    for b in blocks:
        inside = [s for s in rec.spans if s.parent == b.id]
        assert b.self_ns == (b.end_ns - b.start_ns) - sum(s.end_ns - s.start_ns for s in inside)


def test_the_loader_builds_its_items_and_collates_on_the_prefetch_thread(trained):
    _, rec = trained
    builds = rec.named("loader.build")
    # the loader's steps in order, each built once
    keys = [s.key for s in builds]
    assert keys == list(range(len(keys))) and len(keys) >= STEPS
    assert {s.thread for s in builds} == {"loader-prefetch"}
    ids = {s.id for s in builds}
    for name in ("loader.items", "loader.collate"):
        parts = rec.named(name)
        assert len(parts) == len(builds) and {s.parent for s in parts} == ids
    for b in builds:
        items, collate = (next(s for s in rec.named(n) if s.parent == b.id)
                          for n in ("loader.items", "loader.collate"))
        assert b.start_ns <= items.start_ns < items.end_ns <= collate.start_ns
        assert collate.end_ns <= b.end_ns


def test_a_batch_that_waits_for_room_in_the_queue_is_built_once(trained):
    trainer, _ = trained
    loader = trainer.train_loader
    built = []

    def build(step, task=None):
        built.append(step)
        return "mlm", {"step": step}

    loader._build_batch = build
    try:
        batches = iter(loader)
        assert next(batches)[1]["step"] == 0
        time.sleep(2.5)  # the full queue turns the prefetch thread's put away twice
        assert [next(batches)[1]["step"] for _ in range(3)] == [1, 2, 3]
        batches.close()
    finally:
        del loader._build_batch
    assert built == list(range(len(built)))
