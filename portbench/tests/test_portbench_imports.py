"""What the benchmark may load: no JAX and no JAX package anywhere in a run's
process, and nothing of the program in the plain reference. Each check
imports in a fresh interpreter and compares the top-level module names
whole (the program's name begins with the JAX package's)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from portbench.harness import FORBIDDEN, ROOT

HARNESS = ["portbench.run", "portbench.harness", "portbench.control", "portbench.counts",
           "portbench.trace", "portbench.readers", "portbench.world", "portbench.jobs.pretrain",
           "portbench.jobs.dagger"]
REFERENCE = ["portbench.reference." + m for m in
             ("bev", "batching", "config", "data", "dropout", "geometry", "model", "nav",
              "navgraph", "pathdata", "train")]


def loaded_top_names(modules) -> set:
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_the_harness_and_the_program_it_drives_load_no_jax():
    from portbench import harness

    names = loaded_top_names(HARNESS + [
        "vln_bevbert_tpu_torch.pretrain.trainer", "vln_bevbert_tpu_torch.nav.agent",
        "vln_bevbert_tpu_torch.data.loader"])
    assert "vln_bevbert_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)
    # and the per-layer readers, loaded as the harness loads them
    for path in sorted((ROOT / "portbench" / "metrics").glob("*.py")):
        assert callable(harness.metric_reader(path.stem))


def test_the_reference_imports_nothing_of_the_program():
    names = loaded_top_names(REFERENCE)
    assert "vln_bevbert_tpu_torch" not in names
    assert not names & set(FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setattr(sys, "modules", {"vln_bevbert_tpu_torch.nav": None, "os": None})
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"jax.numpy": None, "vln_bevbert_tpu.ops": None})
    assert harness.forbidden_modules() == ["jax", "vln_bevbert_tpu"]
