"""The readings the greedy evaluation cell's limits are set from
(``portbench/limits/r2r_finetune.eval.json``): the program's stage gaps over
many seeds (the lower readings), the control's (the reference one precision
below the configuration's, fp8, put in the program's place at every stage)
and the planted faults' (the upper readings).

    python3 -m portbench.control_eval --workload r2r_finetune.eval --seeds a,b,... \\
        [--control-seeds c,d,e] [--out <file.jsonl>]

Per seed of ``--seeds``: the cell's set-up (the program's two checked
rollouts and the distance probe), the program freed, then the float32
reference's stages and the gaps (``program``). Per seed of
``--control-seeds`` besides, each against the float32 reference on the
same inputs: the control (``control``), and the faults of
``reference/eval.py:FAULTS``: the program's answer altered where it is
produced (``stop_raised``, ``bev_scaled``) and the reference's navigation
forward without the distance bias (``no_distance_bias``) or with the
fusion gate fixed at 0.5 (``gate_fixed``). One JSON line per reading, then
the summary of ``control.summary``. Needs the card unless ``need_card`` is
off (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List

import torch

from . import harness
from .control import FP8, _quiet, summary
from .jobs import eval as eval_job
from .jobs.pretrain import Phases
from .reference import eval as reval


def readings(cell: harness.Cell, seed: int, device, control: bool) -> List[dict]:
    """The gaps of the program and, with ``control``, of the control and
    the faults, at ``seed``."""
    setup = eval_job.Setup(cell, seed, device, Phases(0.0, _quiet))
    rollouts = setup.close()
    steps = int(cell.config["run"]["max_action_len"])
    model, projector = eval_job.reference_model(cell, seed, device), eval_job.projector_of(
        cell, device)
    ref = reval.reference_stages(model, projector, rollouts, steps, device)
    got = reval.program_stages(rollouts)
    out = [("program", reval.gaps(got, ref, rollouts))]
    if control:
        fp8 = eval_job.reference_model(cell, seed, device, FP8)
        ctl = reval.reference_stages(fp8, projector, rollouts, steps, device, fp8=True)
        out.append(("control", reval.gaps(ctl, ref, rollouts)))
        del fp8
        for fault in reval.FAULTS:
            if fault in ("stop_raised", "bev_scaled"):
                wrong = reval.faulty(got, fault)
            else:
                wrong = reval.reference_stages(model, projector, rollouts, steps, device,
                                               fault=fault)
            out.append((fault, reval.gaps(wrong, ref, rollouts)))
    return [{"seed": seed, "kind": kind, **{k: v[0] for k, v in gaps.items()},
             "where": {k: v[1] for k, v in gaps.items()}} for kind, gaps in out]


def main(argv=None, root=harness.ROOT, need_card: bool = True, device_name: str = "cuda"):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = harness.resolve(args.workload, root)
    if need_card and not torch.cuda.is_available():
        print("[portbench] the control needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device(device_name)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    lines = []
    for seed in seeds + sorted(controls - set(seeds)):
        for line in readings(cell, seed, device, seed in controls):
            lines.append(line)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    print(json.dumps({"summary": summary(lines)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
