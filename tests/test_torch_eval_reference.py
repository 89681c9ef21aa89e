"""The greedy evaluation cell (``r2r_finetune.eval``) on the CPU, at a tiny
width in float32: its job's rollout against the plain reference stage by
stage, the planted faults against its compared numbers, the rollout's spans
and counters, a whole run through ``portbench.run``, and its per-layer
readers.

The tiny twin of the cell is built here: ``portbench.tests.tiny.make_root``'s
checkout (whose ``tiny_finetune`` configuration is the cell's at a tiny
width), with the program in float32, the cell's traffic over a tiny world,
and limits for float32 (``TINY_LIMITS``).
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.control import _quiet
from portbench.jobs import eval as eval_job
from portbench.jobs.pretrain import Phases
from portbench.reference import eval as reval
from portbench.tests.tiny import make_root

CELL = "tiny_finetune_f32.tiny_eval"
SEED = 2 ** 32 + 15
WORLD = {"n_scans": 2, "n_nodes": 12, "extent": 12.0, "n_items": 8, "path_len": [3, 5],
         "txt_len": [10, 40]}
#: float32 against float32: the model's stages read 0 (the same float32
#: operations on both sides), the host contraction ~6e-8, the BEV ~2e-3
#: (the point store keeps bf16 features); each limit lies above that and
#: below what the faults read on this twin, the weakest being the dropped
#: distance bias (nav_gap ~2e-5, probe_gap ~2e-4: at this width attention
#: barely moves the residual stream)
TINY_LIMITS = {"text_gap": 1e-5, "pano_gap": 1e-5, "node_gap": 1e-6, "bev_gap": 0.01,
               "nav_gap": 1e-6, "gate_gap": 1e-6, "probe_gap": 1e-5}


def eval_root(tmp: Path) -> Path:
    root = make_root(tmp)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny_finetune.json").read_text())
    cfg["name"] = "tiny_finetune_f32"
    cfg["run"]["model"]["dtype"] = "float32"
    (pb / "configs" / "tiny_finetune_f32.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "eval.json").read_text())
    traffic["world"] = WORLD
    (pb / "traffic" / "tiny_eval.json").write_text(json.dumps(traffic))
    limits = json.loads((pb / "limits" / "r2r_finetune.eval.json").read_text())
    limits["limits"] = TINY_LIMITS
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    c = next(c for c in bench["configs"] if c["name"] == "tiny_finetune")
    bench["configs"].append({**c, "name": "tiny_finetune_f32",
                             "file": "portbench/configs/tiny_finetune_f32.json"})
    w = next(w for w in bench["workloads"] if w["name"] == "r2r_finetune.eval")
    bench["workloads"].append({**w, "name": CELL, "config": "tiny_finetune_f32",
                               "traffic": "tiny_eval"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "r2r_finetune.eval" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return eval_root(tmp_path_factory.mktemp("eval"))


@pytest.fixture(scope="module")
def cell(root):
    return harness.resolve(CELL, root)


@pytest.fixture(scope="module")
def checked(cell):
    """The job's set-up (two checked rollouts and the probe), the program
    freed: the rollouts as its tap kept them."""
    setup = eval_job.Setup(cell, SEED, torch.device("cpu"), Phases(0.0, _quiet))
    return setup.close()


def test_a_greedy_rollout_matches_the_reference_stage_by_stage(cell, checked):
    assert len(checked) == 2 and all(ro["nav"] for ro in checked)
    gaps = {k: v for k, (v, _) in eval_job.reference_checks(
        cell, SEED, checked, torch.device("cpu")).items()}
    # the language and panorama encoders: the same float32 layers in another
    # module layout, so products and sums in another order
    assert gaps["text_gap"] < 1e-5 and gaps["pano_gap"] < 1e-5
    # the host contraction: numpy's einsum against torch's matmul over the
    # same float32 tokens
    assert gaps["node_gap"] < 1e-6
    # the splat's sums of bf16-rounded features (the point store keeps bf16)
    # against float32 sums of the raw features: the rounding of bf16
    assert gaps["bev_gap"] < 5e-3
    # the navigation forward on the program's own inputs, float32 on both
    # sides: only the order of the sums differs
    assert gaps["nav_gap"] < 1e-4 and gaps["gate_gap"] < 1e-5 and gaps["probe_gap"] < 1e-4
    # chained from the token ids and the observations, the BEV's rounding
    # reaches the logits: small, logged, not compared
    assert gaps["logit_gap"] < 1e-2 and gaps["prob_gap"] < 1e-2


def _stop_raised(monkeypatch):
    from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT

    forward = GlocalTextPathNavCMT.forward_navigation_per_step

    def raised(self, batch):
        out = dict(forward(self, batch))
        out["fused_logits"] = out["fused_logits"].clone()
        out["fused_logits"][:, 0] += 0.5
        return out

    monkeypatch.setattr(GlocalTextPathNavCMT, "forward_navigation_per_step", raised)


def _bev_scaled(monkeypatch):
    from vln_bevbert_tpu_torch.nav import agent as agent_mod

    splat = agent_mod.gather_and_splat
    monkeypatch.setattr(agent_mod, "gather_and_splat", lambda *a: splat(*a) * 1.25)


def _no_distance_bias(monkeypatch):
    from vln_bevbert_tpu_torch.models.nav import GlocalTextPathNavCMT

    forward = GlocalTextPathNavCMT.forward_navigation_per_step

    def no_bias(self, batch):
        return forward(self, {**batch, "gmap_pair_dists": batch["gmap_pair_dists"] * 0})

    monkeypatch.setattr(GlocalTextPathNavCMT, "forward_navigation_per_step", no_bias)


def _gate_fixed(monkeypatch):
    from vln_bevbert_tpu_torch.models import nav as nav_mod

    fuse = nav_mod.sap_logits
    monkeypatch.setattr(nav_mod, "sap_logits",
                        lambda g, l, _fuse, *a: fuse(g, l, None, *a))  # noqa: E741


@pytest.mark.parametrize("fault", [_stop_raised, _bev_scaled, _no_distance_bias, _gate_fixed],
                         ids=lambda f: f.__name__.strip("_"))
def test_each_planted_fault_fails_a_compared_number(cell, monkeypatch, fault):
    """The fault planted in the program itself: the job's checks of its
    checked rollouts fail at least one of the cell's compared numbers."""
    fault(monkeypatch)
    setup = eval_job.Setup(cell, SEED, torch.device("cpu"), Phases(0.0, _quiet))
    gaps = eval_job.reference_checks(cell, SEED, setup.close(), torch.device("cpu"))
    checks = harness.checks(gaps, cell.limits, _quiet)
    assert not all(c.ok for c in checks), {c.name: c.value for c in checks}


def test_the_control_and_the_faults_read_above_the_limits_where_the_program_reads_below(cell):
    from portbench import control_eval

    lines = {ln["kind"]: ln for ln in control_eval.readings(cell, SEED, torch.device("cpu"),
                                                            True)}
    assert set(lines) == {"program", "control", *reval.FAULTS}
    assert all(lines["program"][k] <= v for k, v in cell.limits.items()), lines["program"]
    for kind in ("control", *reval.FAULTS):
        assert any(lines[kind][k] > v for k, v in cell.limits.items()), (kind, lines[kind])


# (name, expected calls per rollout step / per rollout / per move)
SPANS = {"rollout.language": "rollout", "env.reset": "rollout", "rollout.panorama": "step",
         "rollout.lift": "step", "rollout.gmap": "step", "rollout.bev": "step",
         "rollout.node_embeds": "step", "rollout.navigation": "step",
         "rollout.teacher": "step", "rollout.act": "step", "env.get_obs": "step",
         "rollout.readback": "two a step", "env.teleport": "move"}


def test_a_recorded_rollout_has_each_span_at_its_place_and_counts_its_work(cell):
    from vln_bevbert_tpu_torch.utils import profiling

    device = torch.device("cpu")
    world = eval_job.world_of(cell, SEED, device)
    cfg, agent = eval_job.program(cell, SEED, world, device)
    agent.model.load_state_dict(eval_job.weights(cell, SEED, device))
    tap = eval_job.Tap(agent, eval_job.projector_of(cell, device))
    passes = eval_job.Passes(agent, tap, len(agent.env.data) // cfg.batch_size)
    try:
        with profiling.recording() as rec:
            trajs = passes.rollout() + passes.rollout()
    finally:
        tap.close()
    counts = agent.counters()
    steps = rec.totals["rollout.panorama"].count
    moves = int(np.sum(passes.moves))
    per = {"rollout": 2, "step": steps, "two a step": 2 * steps, "move": moves}
    assert {n: rec.totals[n].count for n in SPANS} == {n: per[k] for n, k in SPANS.items()}
    # spans nest where the rollout calls the env: a move's teleport inside
    # the step's actions
    act = {s.id for s in rec.named("rollout.act")}
    assert all(s.parent in act for s in rec.named("env.teleport"))
    assert all(s.parent is None for s in rec.named("env.get_obs") + rec.named("env.reset"))
    assert counts["episodes"] == len(trajs) == 2 * cfg.batch_size
    assert counts["rollout_steps"] == steps
    # an episode decides at each step up to the one it ends at
    assert counts["nav_decisions"] == moves + len(trajs)
    assert 0 < counts["gmap_nodes"] <= steps * cfg.batch_size * cfg.shapes.max_gmap_len
    # the node contraction reads the slots of the steps stored so far
    assert 0 < counts["node_tokens"] <= steps * cfg.max_action_len * agent.num_pano_slots
    assert 0 < counts["splat_points"] <= (steps * cfg.batch_size * cfg.shapes.max_pc_steps
                                          * cfg.shapes.num_views * cfg.shapes.grid_hw ** 2)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_run_prints_a_correct_line(root, trace):
    """``portbench.run`` on the tiny twin in a process of its own (this test
    process holds JAX, which a run must not load), without a card."""
    code = ("import sys; from pathlib import Path; from portbench import run; "
            f"sys.exit(run.main(sys.argv[1:], root=Path({str(root)!r}), need_card=False, "
            "device_name='cpu'))")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--workload", CELL, "--seed", str(SEED), "--seconds",
         "0.5", "--trace", str(trace)], capture_output=True, text=True, timeout=600,
        cwd=str(Path(__file__).resolve().parent.parent))
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(TINY_LIMITS)
    assert "decisions per episode" in proc.stderr
    if trace:  # the CPU has no device trace: the program's host spans
        assert set(line["metrics"]) == {"env_ms_per_step.eval", "rollout_host_ms_per_step.eval",
                                        "node_embeds_ms_per_step.eval"}
    else:
        assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


def _record():
    """A window of 10 rollout steps, 4 of them traced."""
    c = {"rollout_steps": 10}
    for name, own, total in (("rollout.gmap", 0.05, 0.05), ("rollout.act", 0.03, 0.04),
                             ("rollout.readback", 0.2, 0.2), ("rollout.node_embeds", 0.4, 0.4),
                             ("env.get_obs", 0.06, 0.06), ("env.teleport", 0.01, 0.01)):
        c[f"self_s:{name}"], c[f"span_s:{name}"], c[f"calls:{name}"] = own, total, 10
    c.update({"phase_s:nav.language": 0.001, "phase_s:nav.panorama": 0.004,
              "phase_s:nav.navigation": 0.025})
    traced = {"window_s": 2.0, "busy_s": 0.1, "flops": 9.89e12, "kernel_s": {"splat": 1e-3},
              "splat_bytes": 1.675e9}
    return harness.Record(counters=c, traced=traced)


@pytest.mark.parametrize("name,want", [
    ("env_ms_per_step.eval", 7.0),                 # (0.06 + 0.01) s over 10 steps
    ("rollout_host_ms_per_step.eval", 48.0),       # own time, readback left out
    ("node_embeds_ms_per_step.eval", 40.0),
    ("nav_device_ms_per_step.eval", 3.0),          # the three phases
    ("step_mfu.eval", 0.5),                        # 9.89 TFLOP over 2 s at 989 TFLOP/s
    ("device_idle_pct.eval", 95.0),
    ("splat_roofline.eval", 50.0),                 # 1.675 GB at 3.35 TB/s over 1 ms
])
def test_each_new_reader_reads_a_synthetic_record(root, name, want):
    read = harness.metric_reader(name, root)
    assert read(_record()) == pytest.approx(want)
    # a program without the spans, counters or trace (the parent's) reads nothing
    assert read(harness.Record()) is None
