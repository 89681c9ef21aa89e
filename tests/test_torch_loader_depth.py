"""The pretraining loader's prefetch queue on the CPU: it holds one whole
block of the task schedule and one batch more (``prefetch`` is its floor),
the thread builds that far ahead of the consumer and then waits for room,
``counters()`` counts the batches it served and the gets that found it
empty, a loader without prefetch starts no thread, and the stream through
the deep queue is the stream built without a thread, bit for bit."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from test_torch_pinned import small_config, small_loader
from vln_bevbert_tpu_torch.data.loader import PretrainLoader

BLOCKS = (1, 4, 8)


def stub_loader(block_size: int, prefetch: int = 2, slow_steps: int = 0):
    """A loader whose batches are ``{"step": step}``, built at once, or in
    0.1 s for the first ``slow_steps`` steps; and the steps it built, in
    the order it built them."""
    cfg = dataclasses.replace(small_config(), task_block_size=block_size)
    loader = PretrainLoader(None, cfg, prefetch=prefetch)
    built = []

    def build(step, task=None):
        if step < slow_steps:
            time.sleep(0.1)
        built.append(step)
        return "mlm", {"step": step}

    loader._build_batch = build
    return loader, built


def prefetch_threads() -> set:
    return {t for t in threading.enumerate() if t.name == "loader-prefetch"}


def settle(built: list, n: int, timeout_s: float = 20.0) -> None:
    """Wait until ``n`` batches are built, then a while longer: the thread
    must have built no more."""
    deadline = time.monotonic() + timeout_s
    while len(built) < n and time.monotonic() < deadline:
        time.sleep(0.005)
    time.sleep(0.2)
    assert len(built) == n, (len(built), n)


def close(batches, started: set) -> None:
    """Close the stream and wait for the threads it started to end."""
    batches.close()
    for t in started:
        t.join(timeout=10)
        assert not t.is_alive()


@pytest.mark.parametrize("prefetch", [2, 6])
@pytest.mark.parametrize("block_size", BLOCKS)
def test_the_prefetch_thread_builds_a_whole_block_and_one_batch_ahead(block_size, prefetch):
    loader, built = stub_loader(block_size, prefetch)
    depth = max(prefetch, block_size + 1)
    assert loader.counters() == {"batches": 0, "waited": 0, "depth": depth}
    before = prefetch_threads()
    batches = iter(loader)
    try:
        assert next(batches)[1]["step"] == 0
        # one taken, ``depth`` queued and one in hand, waiting for room
        settle(built, 1 + depth + 1)
        assert [next(batches)[1]["step"] for _ in range(depth)] == list(range(1, depth + 1))
        settle(built, 1 + 2 * depth + 1)
        assert built == list(range(len(built)))
        assert loader.counters()["batches"] == 1 + depth
    finally:
        close(batches, prefetch_threads() - before)


@pytest.mark.parametrize("block_size", BLOCKS)
def test_a_loader_without_prefetch_starts_no_thread(block_size):
    loader, built = stub_loader(block_size, prefetch=0)
    before = prefetch_threads()
    batches = iter(loader)
    assert [next(batches)[1]["step"] for _ in range(3)] == [0, 1, 2]
    assert prefetch_threads() == before
    assert built == [0, 1, 2]
    assert loader.counters() == {"batches": 0, "waited": 0, "depth": 0}
    batches.close()


@pytest.mark.parametrize("block_size", BLOCKS)
def test_waited_counts_the_gets_that_found_the_queue_empty(block_size):
    loader, built = stub_loader(block_size, slow_steps=3)
    depth = loader.depth
    before = prefetch_threads()
    batches = iter(loader)
    try:
        # each of the first three is asked for before the thread has built it
        assert [next(batches)[1]["step"] for _ in range(3)] == [0, 1, 2]
        assert loader.counters()["waited"] == 3
        # then the thread fills the queue, and the next ``depth`` gets find it full
        settle(built, 3 + depth + 1)
        assert [next(batches)[1]["step"] for _ in range(depth)] == list(range(3, 3 + depth))
        assert loader.counters() == {"batches": 3 + depth, "waited": 3, "depth": depth}
    finally:
        close(batches, prefetch_threads() - before)


def test_the_block_deep_queue_yields_the_unthreaded_stream_bit_for_bit():
    """24 steps, three blocks of 8, through a queue of 9 that the thread
    has filled before the consumer goes on, against a ``prefetch=0`` loader
    of the same seed: the same tasks, and every array of every batch with
    the same dtype, shape and bytes."""
    cfg = dataclasses.replace(small_config(), task_block_size=8)
    deep, plain = small_loader(cfg, seed=5, prefetch=2), small_loader(cfg, seed=5, prefetch=0)
    assert deep.depth == 9 and plain.depth == 0
    built, build = [], deep._build_batch

    def counted(step, task):
        out = build(step, task)
        built.append(step)
        return out

    deep._build_batch = counted
    before = prefetch_threads()
    got, want = iter(deep), iter(plain)
    try:
        items = [next(got)]
        settle(built, 1 + deep.depth + 1)
        items += [next(got) for _ in range(23)]
        for step, (task, batch) in enumerate(items):
            ref_task, ref = next(want)
            assert task == ref_task == deep.meta.task_for_step(step)
            assert batch.keys() == ref.keys()
            for key, v in batch.items():
                a, b = np.asarray(v), np.asarray(ref[key])
                assert a.dtype == b.dtype and a.shape == b.shape, (step, key)
                assert a.tobytes() == b.tobytes(), (step, key)
    finally:
        want.close()
        close(got, prefetch_threads() - before)
    assert deep.counters()["batches"] == 24
