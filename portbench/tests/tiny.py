"""A checkout root for CPU tests: ``BENCHMARK.json`` and the data folders of
``portbench/`` copied into a temporary directory, plus cells of the
repository's configurations cut to a tiny width, so that a whole run fits
in seconds on the CPU."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench.harness import ROOT

DATA_DIRS = ("configs", "traffic", "limits", "metrics")
TINY_MODEL = dict(hidden_size=32, num_attention_heads=2, intermediate_size=64, num_l_layers=1,
                  num_pano_layers=1, num_x_layers=1, image_feat_size=16, bev_grid_feat_size=16,
                  bev_dim=5)
TINY_WORLDS = {"mix": {"n_scans": 2, "n_nodes": 8, "n_items": 16, "path_len": [3, 5],
                       "txt_len": [10, 40]},
               "dagger": {"n_scans": 2, "n_nodes": 8, "n_items": 8, "path_len": [3, 5],
                          "txt_len": [10, 40]}}
#: the repository's cells and their tiny twins
TINY_CELLS = {"r2r_pretrain.mix": ("tiny_pretrain", "tiny_mix", 4),
              "r2r_finetune.dagger": ("tiny_finetune", "tiny_dagger", 2)}
#: DAgger fine-tuning's entries, which ``BENCHMARK.json`` does not list (its
#: runs spread too widely to hold a bound): its job stays under test here
PARKED = {
    "configs": [{"name": "r2r_finetune", "file": "portbench/configs/r2r_finetune.json",
                 "source": "https://github.com/MarSaKi/VLN-BEVBert", "why": "DAgger agent",
                 "reduced": ["num_gpus", "train_datasets", "bert_ckpt_file"]}],
    "workloads": [{"name": "r2r_finetune.dagger", "config": "r2r_finetune",
                   "traffic": "dagger", "chips": 1, "why": "DAgger at B=4"}],
    "end_to_end": [
        {"name": name, "unit": unit, "better": better, "bound": 0.25, "source": "host_clock",
         "workloads": ["r2r_finetune.dagger"]}
        for name, unit, better in (("episodes_per_s", "episodes/s", "higher"),
                                   ("nav_step_ms_p95", "ms", "lower"))],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
         "moves": moves, "workloads": ["r2r_finetune.dagger"]}
        for name, unit, better, source, layer, moves in (
            ("step_mfu.dagger", "%", "higher", "device_trace", "model step", "episodes_per_s"),
            ("device_idle_pct.dagger", "%", "lower", "device_trace", "device",
             "episodes_per_s"),
            ("dropout_roofline.dagger", "%", "higher", "device_trace", "kernel csrc/dropout.cu",
             "episodes_per_s"),
            ("update_ms.dagger", "ms", "lower", "program_span", "replay update",
             "episodes_per_s"),
            ("splat_roofline.dagger", "%", "higher", "device_trace", "kernel csrc/splat.cu",
             "nav_step_ms_p95"),
            ("env_ms_per_step.dagger", "ms", "lower", "program_span", "env",
             "nav_step_ms_p95"))],
}


def make_root(tmp: Path, limits=None) -> Path:
    """A root under ``tmp`` with every cell of the repository, the parked
    DAgger cell, and a tiny twin of each (``tiny_pretrain.tiny_mix``,
    ``tiny_finetune.tiny_dagger``), whose limits are ``limits`` (by number)
    or the cell's own."""
    root = Path(tmp) / "checkout"
    for d in DATA_DIRS:
        shutil.copytree(ROOT / "portbench" / d, root / "portbench" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, entries in PARKED.items():
        bench[key] += copy.deepcopy(entries)
    for cell, (cfg_name, traffic_name, batch) in TINY_CELLS.items():
        w = next(w for w in bench["workloads"] if w["name"] == cell)
        c = next(c for c in bench["configs"] if c["name"] == w["config"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["name"] = cfg_name
        cfg["run"]["model"].update(TINY_MODEL)
        cfg["run"]["shapes"]["grid_hw"] = 4
        cfg["run"]["train_batch_size" if "train_batch_size" in cfg["run"] else "batch_size"] = batch
        (root / "portbench" / "configs" / f"{cfg_name}.json").write_text(json.dumps(cfg))
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        traffic["world"] = TINY_WORLDS[w["traffic"]]
        (root / "portbench" / "traffic" / f"{traffic_name}.json").write_text(json.dumps(traffic))
        name = f"{cfg_name}.{traffic_name}"
        own = json.loads((ROOT / "portbench" / "limits" / f"{cell}.json").read_text())
        own["limits"] = dict(limits or own["limits"])
        (root / "portbench" / "limits" / f"{name}.json").write_text(json.dumps(own))
        bench["configs"].append({**copy.deepcopy(c), "name": cfg_name,
                                 "file": f"portbench/configs/{cfg_name}.json"})
        bench["workloads"].append({**w, "name": name, "config": cfg_name,
                                   "traffic": traffic_name})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
