"""The readings a cell's limits are set from: the program's numbers over many
seeds (the lower readings), the control's (the reference one precision below
the configuration's, put in the program's place) and the planted faults'
(the upper readings).

    python3 -m portbench.control --workload <cell> --seeds a,b,... \\
        [--control-seeds c,d,e] [--out <file.jsonl>]

Per seed of ``--seeds``: the cell's set-up (the program's checked steps),
the program freed, then the float32 reference and the gaps (``program``).
Per seed of ``--control-seeds`` besides, each against the float32
reference: the control, the reference in fp8 (``control``); the reference
with half of each batch left out and the mean taken over the rest
(``half_batch``); for pretraining the reference with its update's sign
turned (``update_negated``) and with its weight decay left out
(``no_weight_decay``); and for DAgger an answer altered where it is produced,
in the program's recorded rollouts: the BEV features scaled by 1.25
(``bev_altered``) and the stop logit raised by 0.5 (``logits_altered``).
A pretraining step produces no answer beside its state and loss. A state left
unchanged reads 1 by the leaf measure and needs no run. One JSON line per
reading, then a summary: the largest program reading and the smallest
control and fault readings of each number. Needs the card unless
``need_card`` is off (the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch

from . import harness
from .jobs import dagger as dagger_job
from .jobs import pretrain as pretrain_job
from .reference import model as rmodel
from .reference import train as rtrain

FP8 = rmodel.Numerics(torch.bfloat16, fp8=True)


def half_rows(batch: dict) -> dict:
    """The first half of a host batch's rows: every key is batch-leading."""
    return {k: v[: len(v) // 2] for k, v in batch.items()}


def stop_likelier(logits: torch.Tensor) -> torch.Tensor:
    """Fused logits with the stop action's raised by 0.5 (an answer altered)."""
    out = logits.clone()
    out[:, 0] += 0.5
    return out


def _quiet(msg: str) -> None:
    pass


def readings(cell: harness.Cell, seed: int, device, control: bool) -> List[dict]:
    """The gaps of the program and, with ``control``, of the control and the
    half-batch fault, at ``seed``."""
    record, timeline = harness.Record(), None
    phases = pretrain_job.Phases(0.0, _quiet)
    out = []
    if cell.job == "pretrain":
        setup = pretrain_job.Setup(cell, seed, device, record, phases)
        prog, world = setup.prog, setup.world
        setup.close()
        ref = pretrain_job.reference_readings(cell, world, seed, device)
        out.append(("program", rtrain.compare(prog, ref)))
        if control:
            ctl = pretrain_job.reference_readings(cell, world, seed, device, FP8)
            out.append(("control", rtrain.compare(ctl, ref)))
            half = pretrain_job.reference_readings(cell, world, seed, device,
                                                   batch_filter=half_rows)
            out.append(("half_batch", rtrain.compare(half, ref)))
            lr = cell.config["run"]["optim"]["learning_rate"]
            for kind, change in (("update_negated", {"learning_rate": -lr}),
                                 ("no_weight_decay", {"weight_decay": 0.0})):
                wrong = pretrain_job.reference_readings(cell, world, seed, device,
                                                        optim_change=change)
                out.append((kind, rtrain.compare(wrong, ref)))
    else:
        from . import trace as tr

        timeline = tr.Timeline()
        setup = dagger_job.Setup(cell, seed, device, record, timeline, phases)
        prog = setup.prog
        rollouts = setup.close()
        ref = dagger_job.reference_outputs(cell, seed, rollouts, device)
        got = dagger_job.program_outputs(rollouts, prog)
        out.append(("program", dagger_job.output_gaps(got, ref)))
        if control:
            ctl = dagger_job.reference_outputs(cell, seed, rollouts, device, FP8)
            out.append(("control", dagger_job.output_gaps(ctl, ref)))
            b = rollouts[0]["bundle"]["targets"].shape[1]
            half = dagger_job.reference_outputs(cell, seed, rollouts, device,
                                                rows=slice(0, b // 2))
            out.append(("half_batch", rtrain.compare(half.readings, ref.readings)))
            bevs = dagger_job.Outputs([b * 1.25 for b in got.bevs], got.logits, prog)
            out.append(("bev_altered", dagger_job.output_gaps(bevs, ref)))
            logits = dagger_job.Outputs(got.bevs, [[stop_likelier(x) for x in steps]
                                                   for steps in got.logits], prog)
            out.append(("logits_altered", dagger_job.output_gaps(logits, ref)))
    return [{"seed": seed, "kind": kind, **{k: v[0] for k, v in gaps.items()},
             "where": {k: v[1] for k, v in gaps.items()}} for kind, gaps in out]


def summary(lines: List[dict]) -> Dict[str, dict]:
    """Per number: the largest program reading, the smallest reading of the
    control and of each fault."""
    out: Dict[str, dict] = {}
    names = [k for k in lines[0] if k not in ("seed", "kind", "where")]
    kinds = list(dict.fromkeys(ln["kind"] for ln in lines))
    for name in names:
        row = {}
        for kind in kinds:
            vals = [ln[name] for ln in lines if ln["kind"] == kind and name in ln]
            if vals:
                row[kind] = (max if kind == "program" else min)(vals)
        out[name] = row
    return out


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
