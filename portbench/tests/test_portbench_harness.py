"""The harness on the CPU at a tiny width: it finds cells, configurations,
traffic and metrics by name; a whole run prints the contract's last line and
comes out correct; a run whose timed path is broken underneath comes out
not correct; and the control, put in the program's place, reads above the
limits. The runs skip the harness's look for a card (``need_card=False``)."""

from __future__ import annotations

import io
import json
import shutil
from contextlib import redirect_stderr, redirect_stdout

import pytest
import torch

from portbench import control, harness, run
from portbench.tests.tiny import make_root

PRETRAIN, DAGGER = "tiny_pretrain.tiny_mix", "tiny_finetune.tiny_dagger"
#: between what sound tiny runs read at SEED and what the faults and the
#: control read there (``python -m portbench.control`` on the tiny cells)
TINY_LIMITS = {
    PRETRAIN: {"grad_gap": 0.03, "grad_elem_gap": 0.04, "change_gap": 0.1},
    DAGGER: {"loss_gap": 5e-4, "grad_gap": 0.15, "grad_elem_gap": 0.05,
             "change_median_gap": 0.02, "bev_gap": 0.02},
}
SEED = 2 ** 31 + 99


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("harness"))
    for name in (PRETRAIN, DAGGER):
        path = root / "portbench" / "limits" / f"{name}.json"
        limits = json.loads(path.read_text())
        assert set(limits["limits"]) == set(TINY_LIMITS[name])  # the cell's own numbers
        limits["limits"] = TINY_LIMITS[name]
        path.write_text(json.dumps(limits))
    return root


def run_cell(root, cell, seconds=0.5, trace=0, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(trace)], root=root, need_card=False, device_name="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_the_harness_finds_a_new_cell_config_traffic_and_metric_by_name(tmp_path):
    root = make_root(tmp_path)
    pb = root / "portbench"
    shutil.copy(pb / "configs" / "tiny_pretrain.json", pb / "configs" / "extra.json")
    shutil.copy(pb / "traffic" / "tiny_mix.json", pb / "traffic" / "extra_mix.json")
    shutil.copy(pb / "limits" / f"{PRETRAIN}.json", pb / "limits" / "extra.extra_mix.json")
    (pb / "metrics" / "extra_steps.pretrain.py").write_text(
        "def read(record):\n    return record.counters.get('steps')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "extra", "source": "test", "reduced": [], "why": "test",
                             "file": "portbench/configs/extra.json"})
    bench["workloads"].append({"name": "extra.extra_mix", "config": "extra",
                               "traffic": "extra_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "extra_steps.pretrain", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "trainer", "moves": "samples_per_s",
                               "workloads": ["extra.extra_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.resolve("extra.extra_mix", root)
    assert cell.job == "pretrain" and cell.config_name == "extra"
    assert [m["name"] for m in cell.per_layer] == ["extra_steps.pretrain"]
    assert harness.metric_reader("extra_steps.pretrain", root)(
        harness.Record(counters={"steps": 7})) == 7
    with pytest.raises(harness.HarnessError, match="unknown workload 'nope'.*extra.extra_mix"):
        harness.resolve("nope", root)
    err = io.StringIO()
    with redirect_stderr(err):
        assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"], root=root,
                        need_card=False, device_name="cpu") == 2
    assert "unknown workload 'nope'" in err.getvalue()


def test_a_run_needs_the_card_it_asks_for(root):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", PRETRAIN, "--seed", "1", "--seconds", "1"], root=root)
    assert rc == 2 and out.getvalue() == "" and "needs 1 CUDA card" in err.getvalue()


@pytest.mark.parametrize("cell,trace", [(PRETRAIN, 0), (DAGGER, 1)])
def test_a_tiny_run_is_correct_and_prints_the_contract_line(root, cell, trace):
    rc, line, err = run_cell(root, cell, trace=trace)
    assert rc == 0, err[-3000:]
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = harness.resolve(cell, root)
    if trace:  # the CPU has no trace: only the host spans' metrics
        assert set(line["metrics"]) <= {m["name"] for m in want.per_layer}
        assert "update_ms.dagger" in line["metrics"]
    else:
        assert set(line["metrics"]) == {m["name"] for m in want.end_to_end}
    assert set(line["checks"]) == set(want.limits)
    tail = err.strip().splitlines()[-len(want.limits):]
    assert all(s.startswith("[portbench] check ") for s in tail)


def _frozen_state(monkeypatch):
    """Every step returns its state unchanged (the host counts move on)."""
    from vln_bevbert_tpu_torch.parallel.train_step import TrainState

    def frozen(self, moves=None):
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_zero_(grads)
        if moves is None:
            self.tx.advance(self.tx.moves_next)
        return gnorm

    monkeypatch.setattr(TrainState, "apply_gradients", frozen)


def _half_pretrain_batch(monkeypatch):
    from vln_bevbert_tpu_torch.models.glocal import GlocalTextPathCMTPreTraining

    forward = GlocalTextPathCMTPreTraining.forward

    def half(self, batch, task):
        b = len(next(iter(batch.values())))
        return forward(self, {k: v[: b // 2] for k, v in batch.items()}, task)

    monkeypatch.setattr(GlocalTextPathCMTPreTraining, "forward", half)


def _half_episodes(monkeypatch):
    from vln_bevbert_tpu_torch.nav.agent import GMapNavAgent

    from portbench.reference.nav import rows_of

    loss = GMapNavAgent._episode_loss

    def half(self, rb, skip=None):
        b = rb["targets"].shape[1]
        return loss(self, rows_of(rb, slice(0, b // 2)), skip)

    monkeypatch.setattr(GMapNavAgent, "_episode_loss", half)


def _altered_bev(monkeypatch):
    from vln_bevbert_tpu_torch.nav import agent as agent_mod

    splat = agent_mod.gather_and_splat
    monkeypatch.setattr(agent_mod, "gather_and_splat", lambda *a: splat(*a) * 1.25)


@pytest.mark.parametrize("cell,fault", [
    (PRETRAIN, _frozen_state), (PRETRAIN, _half_pretrain_batch),
    (DAGGER, _frozen_state), (DAGGER, _half_episodes), (DAGGER, _altered_bev)])
def test_a_broken_timed_path_comes_out_not_correct(root, monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, err = run_cell(root, cell)
    assert rc == 0, err[-3000:]
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", [PRETRAIN, DAGGER])
def test_the_control_and_the_half_batch_fault_read_above_the_limits(root, cell):
    c = harness.resolve(cell, root)
    lines = {ln["kind"]: ln for ln in control.readings(c, SEED, torch.device("cpu"), True)}
    assert all(lines["program"][k] <= v for k, v in c.limits.items()), lines["program"]
    for kind in ("control", "half_batch"):
        assert any(lines[kind][k] > v for k, v in c.limits.items() if k in lines[kind]), \
            lines[kind]
