"""Pretraining as users run it: ``PretrainTrainer.train`` over the program's
``PretrainLoader``, in blocks of one task (``_train_blocked``), each step a
replay of a CUDA graph of the whole step (``make_pretrain_block_step``).

Set-up (``setup_s``, from process start): the world from the seed, the
trainer, the benchmark's weights and dropout generator, a capture of every
graph the window can replay (each task at each trajectory bucket the
traffic can produce), then three checked steps, one block each, through
``train``: a batch of each task (mlm, sap, masksem), built by the program's
loader under step keys the window never reaches, so that every seed checks
the same work. The optimizer's count starts at the end of the warm-up
(``check_count``), so that these steps, and the window after them, run at the
configuration's peak learning rate. These are the steps the reference
follows.

The window: ``train`` over the loader's own stream until ``--seconds`` have passed at the
end of a block; ``samples_per_s`` is every sample of every block dispatched
in the window over the window's wall time, up to the end of its device
work. With ``--trace 1`` the first ``trace_blocks`` blocks of the window are
traced.

After the window (the program freed): the reference's three steps in
float32 from the same weights, the same dropout seeds and batches it builds
itself, and the comparison (``reference/train.py:compare``).
"""

from __future__ import annotations

import gc
import math
import tempfile
import time
from collections import deque
from typing import Dict, List

import numpy as np
import torch

from .. import counts, trace as tr
from .. import harness
from ..harness import Cell, Record, Result
from ..reference import bev as rbev, data as rdata, model as rmodel, train as rtrain
from ..reference.config import settings
from ..world import make_world

#: the loader's step keys of the checked batches, one per task, out of the
#: window's reach
CHECK_KEY = 10 ** 9 + 100


class WindowClosed(Exception):
    pass


class Phases:
    """Logs the seconds each phase of a run took."""

    def __init__(self, t_start: float, log):
        self.t, self.log = t_start, log

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.log(f"[portbench] phase {name}: {now - self.t:.2f} s")
        self.t = now


def check_count(cell: Cell) -> int:
    """The optimizer's update count at the first checked step: the end of
    the warm-up, where the learning rate peaks (a step inside the warm-up
    moves the parameters by almost nothing)."""
    return int(cell.config["run"]["optim"]["warmup_steps"])


def dropout_seed(seed: int) -> int:
    return (seed * 2654435761 + 97) % (1 << 63)


def world_of(cell: Cell, seed: int, device="cpu"):
    m, s = settings(cell.config["run"])
    return make_world(cell.traffic["world"], seed, m.image_feat_size, m.bev_grid_feat_size,
                      s.grid_hw, s.num_views, m.num_sem_classes, device)


def reference_model(cell: Cell, num: rmodel.Numerics, device) -> rmodel.PretrainModel:
    m, _ = settings(cell.config["run"])
    with torch.device("meta"):
        model = rmodel.PretrainModel(m, tuple(cell.config["run"]["tasks"]), num)
    return model.to_empty(device=device)


def weights(cell: Cell, seed: int, device) -> Dict[str, torch.Tensor]:
    """The cell's float32 weights from ``seed``, made on ``device``."""
    m, _ = settings(cell.config["run"])
    with torch.device("meta"):
        shape_model = rmodel.PretrainModel(m, tuple(cell.config["run"]["tasks"]))
    named = [(n, tuple(p.shape)) for n, p in shape_model.named_parameters()]
    kinds = {n: rmodel.init_kind(n, p, shape_model) for n, p in shape_model.named_parameters()}
    return rtrain.seeded_weights(named, kinds, seed, device, m.initializer_range)


# ------------------------------------------------------------------ program
def program_config(cell: Cell, seed: int):
    from vln_bevbert_tpu_torch.configs import PretrainConfig, load_config

    cfg = load_config(PretrainConfig, None, **cell.config["run"])
    cfg.seed = seed
    return cfg


def program_db(cfg, world):
    from vln_bevbert_tpu_torch.data.feature_db import DictFeatureDB
    from vln_bevbert_tpu_torch.data.nav_graph import NavGraph, build_scanvp_cands
    from vln_bevbert_tpu_torch.data.pathdata import TextPathData

    graphs = {s: NavGraph(*g) for s, g in world.scans.items()}
    return TextPathData(
        world.annotations, graphs, build_scanvp_cands(graphs),
        view_db=DictFeatureDB(world.views), grid_db=DictFeatureDB(world.grids),
        depth_db=DictFeatureDB(world.depths), sem_db=DictFeatureDB(world.sems),
        image_feat_size=cfg.model.image_feat_size, max_txt_len=cfg.shapes.max_txt_len,
        bev_dim=cfg.model.bev_dim, bev_res=cfg.model.bev_res, num_views=cfg.shapes.num_views)


class Feed:
    """The loader handed to the trainer: one stream of batches across its
    ``train`` calls (each call takes up where the last stopped), each
    batch's signature remembered until its step is dispatched, and the
    loader's batch building timed (``loader`` span)."""

    def __init__(self, loader, record: Record):
        self.loader = loader
        self.global_batch_size = loader.global_batch_size
        self.sigs: deque = deque()
        self.first: deque = deque()  # batches served before the loader's own
        build = loader.build_batch

        def timed(step, task=None):
            t0 = time.perf_counter()
            out = build(step, task)
            record.spans.setdefault("loader", []).append(time.perf_counter() - t0)
            return out

        loader.build_batch = timed
        self.stream = iter(loader)

    def __iter__(self):
        def batches():
            while True:
                item = self.first.popleft() if self.first else next(self.stream)
                self.sigs.append(counts.signature(item[1]))
                yield item

        return batches()

    def close(self) -> None:
        self.stream.close()


def resize_steps(batch: Dict[str, np.ndarray], T: int, P: int) -> Dict[str, np.ndarray]:
    """``batch`` cut or zero-padded to ``T`` trajectory steps (a warm-up
    batch of that bucket's signature)."""
    out = {}
    for key, v in batch.items():
        if key.startswith("traj_") and v.ndim >= 2:
            axis, size = 1, T
        elif key == "gmap_agg":
            axis, size = 2, T * P
        else:
            out[key] = v
            continue
        if v.shape[axis] >= size:
            out[key] = np.take(v, np.arange(size), axis=axis)
        else:
            pad = [(0, 0)] * v.ndim
            pad[axis] = (0, size - v.shape[axis])
            out[key] = np.pad(v, pad)
    out["traj_last_step"] = np.minimum(batch["traj_last_step"], T - 1)
    return out


def step_buckets(cell: Cell) -> List[int]:
    """The trajectory buckets (multiples of 4 up to ``max_steps``) that paths
    of 1 to ``path_len[1]`` viewpoints fall into."""
    max_steps = cell.config["run"]["shapes"]["max_steps"]
    longest = cell.traffic["world"]["path_len"][1]
    return sorted({min((n + 3) // 4 * 4, max_steps) for n in range(1, longest + 1)})


def capture_all(trainer, loader, cell: Cell) -> int:
    """Capture the graph of every (task, bucket) the window can replay, as
    the block step keys them; the state is left as it was."""
    from vln_bevbert_tpu_torch.parallel import train_step
    from vln_bevbert_tpu_torch.utils import graphs

    cache = getattr(trainer.block_fn, "graphs", None)
    if cache is None:  # the CPU: eager blocks, nothing to capture
        return 0
    step_fn = train_step.make_pretrain_step(trainer.model, trainer.projector)
    state = trainer.state
    P = trainer.cfg.shapes.max_pano_len
    made = 0
    for i, task in enumerate(trainer.cfg.tasks):
        _, real = loader.build_batch(10 ** 9 + i, task=task)
        for T in step_buckets(cell):
            b = resize_steps(real, T, P)
            moves = state.tx.moves_next
            key = (task, graphs.signature(b), moves)
            if cache.get(key) is not None:
                continue
            inputs = cache.inputs_for(b, state.params[0].device)
            cache.load(inputs, b)
            cache.capture(key, inputs,
                          lambda inputs=inputs, task=task, moves=moves:
                          step_fn(state, inputs, task, moves),
                          state.device_state(), train_step.dropout_generators(trainer.model))
            made += 1
    return made


def read_first_gradient(state, out: rtrain.Readings) -> None:
    """Each leaf's gradient as AdamW received it at the first update, into
    ``out``: its second moment then holds ``(1 - b2) * g**2``, whence the
    leaf's norm and its magnitudes (on the host)."""
    b2 = state.tx.b2
    sums = torch.stack([v.double().sum() for v in state.tx.nu]).tolist()
    out.grad_norms = {n: math.sqrt(max(s, 0.0) / (1.0 - b2)) for n, s in zip(state.names, sums)}
    out.grad_abs = {n: (v / (1.0 - b2)).sqrt().cpu() for n, v in zip(state.names, state.tx.nu)}


def leaf_change_norms(model, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    norms = []
    for n, p in model.named_parameters():
        norms.append((p.detach() - start[n].to(p.device, non_blocking=True)).norm())
    return dict(zip([n for n, _ in model.named_parameters()], torch.stack(norms).tolist()))


# ---------------------------------------------------------------- reference
def reference_readings(cell: Cell, world, seed: int, device,
                       num: rmodel.Numerics = rmodel.Numerics(),
                       batch_filter=None, optim_change=None) -> rtrain.Readings:
    """The reference's checked steps (one per task), each its own block, from
    the seed's weights, dropout seeds and batches, at the program's update
    count. ``batch_filter`` changes each host batch first, ``optim_change``
    the optimizer's settings (planted faults)."""
    run = cell.config["run"]
    m, s = settings(run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference_model(cell, num, device)
    model.load_state_dict(weights(cell, seed, device))
    model.train()
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(dropout_seed(seed))
    rmodel.set_generator(model, gen)
    projector = rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res,
                               m.num_sem_classes, device=device)
    db = rdata.text_path_data(world, m, s)
    steps = [rdata.build_batch(db, run, m, s, seed, CHECK_KEY + k, task=t)
             for k, t in enumerate(run["tasks"])]
    if batch_filter is not None:
        steps = [(task, batch_filter(b)) for task, b in steps]

    def loss_fn(task, batch):
        return lambda: reference_loss(model, projector, batch, task, device)

    optim = {**run["optim"], **(optim_change or {})}
    return rtrain.train_steps(model, [loss_fn(t, b) for t, b in steps], optim,
                              optim["grad_norm"], start_count=check_count(cell))


def reference_loss(model, projector, batch: Dict[str, np.ndarray], task: str, device):
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    bev, sem, sem_mask = projector.lift_splat(b.pop("depths"), b.pop("T_c2w"), b.pop("T_w2c"),
                                              b.pop("S_w2c"), b.pop("grid_fts"),
                                              b.pop("sem_labels"))
    b.update(bev_fts=bev, bev_sems=sem, bev_sem_masks=sem_mask)
    if task == "mlm":
        b["txt_ids"] = b["mlm_ids"]
    return model(b, task)


def counter_of(cell: Cell) -> counts.StepCounts:
    """FLOPs and dropout bytes of a step, by the reference at the program's
    precision on the meta device."""
    m, s = settings(cell.config["run"])
    with torch.device("meta"):
        model = rmodel.PretrainModel(m, tuple(cell.config["run"]["tasks"]),
                                     rmodel.Numerics(torch.bfloat16))
    model.train()
    projector = rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res,
                               m.num_sem_classes, device="meta")

    def loss_of(task, batch):
        b = dict(batch)
        bev, sem, sem_mask = projector.lift_splat(b.pop("depths"), b.pop("T_c2w"),
                                                  b.pop("T_w2c"), b.pop("S_w2c"),
                                                  b.pop("grid_fts"), b.pop("sem_labels"))
        b.update(bev_fts=bev, bev_sems=sem, bev_sem_masks=sem_mask)
        if task == "mlm":
            b["txt_ids"] = b["mlm_ids"]
        return model(b, task)

    return counts.StepCounts(model, loss_of)


# ---------------------------------------------------------------------- run
class Window:
    """Wraps the trainer's block step: spans, counts, the traced blocks and
    the close of the window at the end of a block."""

    def __init__(self, trainer, feed: Feed, record: Record, timeline: tr.Timeline,
                 counter: counts.StepCounts, cell: Cell, device):
        self.block = trainer.block_fn
        self.feed, self.record, self.timeline = feed, record, timeline
        self.counter, self.cell, self.device = counter, cell, device
        self.deadline = math.inf
        self.steps = 0
        self.losses: List[torch.Tensor] = []
        self.trace_left = 0
        self.prof = None
        self.t_trace = 0.0
        m, s = settings(cell.config["run"])
        self.projector = rbev.Projector(s.grid_hw, s.num_views, m.bev_dim, m.bev_res,
                                        m.num_sem_classes)
        self.model_settings, self.shape_settings = m, s
        trainer.block_fn = self

    def open(self, seconds: float, trace_blocks: int) -> None:
        # set-up's train calls each took exactly the batches they trained
        self.feed.sigs.clear()
        self.record.spans.clear()
        self.steps, self.losses = 0, []
        if trace_blocks and self.device.type == "cuda":
            self.prof = tr.start(self.device)
            self.timeline.on = True
            self.trace_left = trace_blocks
            self.traced_steps = []
        self.t_trace = time.perf_counter()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def __call__(self, state, batch, task, length, stacked=False):
        with self.record.span("dispatch"), self.timeline.span("dispatch"):
            out = self.block(state, batch, task, length, stacked=stacked)
        sigs = [self.feed.sigs.popleft() for _ in range(length)]
        self.steps += length
        self.losses.append((length, out["loss"]))
        if self.trace_left:
            self._count(task, batch if stacked else [batch] * length, sigs)
            self.trace_left -= 1
            if not self.trace_left:
                self._stop_trace()
        if time.perf_counter() >= self.deadline:
            raise WindowClosed
        return out

    def _count(self, task: str, block: list, sigs: list) -> None:
        """Keep what the traced steps' work is counted from after the window:
        the task, the batch's signature as the loader made it and as the
        block padded it, and the poses and depths that decide which BEV
        points are valid."""
        for b, sig in zip(block, sigs):
            geo = {k: np.asarray(b[k]) for k in ("depths", "T_c2w", "T_w2c", "S_w2c")}
            self.traced_steps.append((task, sig, counts.signature(b), geo,
                                      np.asarray(b["grid_fts"]).shape,
                                      np.asarray(b["grid_fts"]).dtype.itemsize))

    def counted(self) -> dict:
        m = self.model_settings
        out = {"flops": 0.0, "dropout_bytes": 0.0, "splat_bytes": 0.0,
               "steps": len(self.traced_steps)}
        for task, sig, padded, geo, (_, n_points, feat_dim), feat_bytes in self.traced_steps:
            out["flops"] += self.counter(task, sig)[0]
            out["dropout_bytes"] += self.counter(task, padded)[1]
            valid = self.projector.valid_points(*(torch.from_numpy(geo[k]) for k in
                                                  ("depths", "T_c2w", "T_w2c", "S_w2c")))
            for v in valid.tolist():
                out["splat_bytes"] += counts.splat_bytes(
                    v, n_points, feat_dim, feat_bytes, m.num_bev_tokens,
                    feat_dim + m.num_sem_classes + 1, True)
        return out

    def _stop_trace(self) -> None:
        torch.cuda.synchronize(self.device)
        self.traced_s = time.perf_counter() - self.t_trace
        self.prof.stop()
        self.timeline.on = False

    def reduce_trace(self) -> dict:
        if self.prof is None:
            return {}
        if self.trace_left:  # the window closed first
            self._stop_trace()
        out = tr.reduce(self.prof, self.timeline, self.traced_s)
        out.update(self.counted())
        return out


class Setup:
    """The program as set-up leaves it: the trainer over its loader, after
    the checked steps, and their readings."""

    def __init__(self, cell: Cell, seed: int, device, record: Record, phases: "Phases"):
        from vln_bevbert_tpu_torch.data.loader import PretrainLoader
        from vln_bevbert_tpu_torch.ops.dropout import set_dropout_generator
        from vln_bevbert_tpu_torch.pretrain.trainer import PretrainTrainer

        self.world = world_of(cell, seed, device)
        phases("start, imports, card and world")
        cfg = program_config(cell, seed)
        # as cli/pretrain.py runs it: bf16 GEMMs accumulate in float32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        # as cli/pretrain.py builds it
        self.loader = PretrainLoader(program_db(cfg, self.world), cfg, seed=cfg.seed,
                                     num_workers=cfg.num_workers)
        self.feed = Feed(self.loader, record)
        self.out_dir = tempfile.TemporaryDirectory(prefix="portbench-")
        self.trainer = trainer = PretrainTrainer(cfg, self.feed, device,
                                                 output_dir=self.out_dir.name)
        start = weights(cell, seed, device)
        trainer.model.load_state_dict(start)
        start = {n: t.cpu() for n, t in start.items()}
        gen = torch.Generator(device=device)
        gen.manual_seed(dropout_seed(seed))
        set_dropout_generator(trainer.model, gen)
        first = check_count(cell)
        trainer.state.tx.set_counts(first, 0)
        phases("trainer and weights")
        self.captured = capture_all(trainer, self.loader, cell)
        phases("captures")
        self.prog = prog = rtrain.Readings()
        tasks = list(cfg.tasks)
        self.feed.first.extend(self.loader.build_batch(CHECK_KEY + k, task=t)
                               for k, t in enumerate(tasks))
        for step in range(1, len(tasks) + 1):
            meters = trainer.train(num_steps=first + step)
            prog.losses.append(next(v for k, v in meters.items() if k.endswith("/loss")))
            if step == 1:
                read_first_gradient(trainer.state, prog)
        prog.change_norms = leaf_change_norms(trainer.model, start)

    def close(self) -> None:
        """Stop the loader and free the program's state on the card."""
        self.feed.close()
        del self.trainer, self.loader, self.feed
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        self.out_dir.cleanup()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float, log=print) -> Result:
    record, timeline = Record(), tr.Timeline()
    phases = Phases(t_start, log)
    setup = Setup(cell, seed, device, record, phases)
    trainer, feed, world, prog = setup.trainer, setup.feed, setup.world, setup.prog
    captured = setup.captured
    counter = counter_of(cell) if trace else None
    window = Window(trainer, feed, record, timeline, counter, cell, device)
    cache = getattr(window.block, "graphs", None)
    before = dict(cache.counters()) if cache is not None else {}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    phases("checked steps")

    window.open(seconds, int(cell.traffic["trace_blocks"]) if trace else 0)
    try:
        trainer.train(num_steps=10 ** 12)
    except WindowClosed:
        pass
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_s = time.perf_counter() - window.t0
    phases("window")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = window.reduce_trace()
    if cache is not None:
        after = cache.counters()
        log(f"[portbench] graphs: {captured} captured in set-up "
            f"({before['capture_ms']:.1f} ms), {after['captures'] - before['captures']} "
            f"captured and {after['replays'] - before['replays']} replayed in the window")
    # a block whose last loss is not finite counts its steps as failed
    lengths = [n for n, _ in window.losses]
    losses = torch.stack([v for _, v in window.losses]).float().tolist() if lengths else []
    failed = sum(n for n, v in zip(lengths, losses) if not math.isfinite(v))
    steps = window.steps
    samples = steps * feed.global_batch_size
    record.counters.update(steps=steps, window_s=window_s)
    if traced:
        record.traced = traced
    del trainer, window, feed
    setup.close()
    phases("trace and counts")
    ref = reference_readings(cell, world, seed, device)
    phases("reference")
    checks = harness.checks(rtrain.compare(prog, ref), cell.limits, log)
    log(f"[portbench] losses program {prog.losses} reference {ref.losses}")
    return Result(
        attempted=steps, failed=failed, checks=checks, memory_peak_bytes=memory_peak,
        end_to_end={"samples_per_s": samples / window_s, "setup_s": setup_s},
        record=record, breakdown=traced.get("breakdown") if traced else None)
