"""VLN-CE episode dataset loading — the reference's habitat dataset classes
as plain parsers.

The reference registers ``VLN-CE-v1`` / ``RxR-VLN-CE-v1`` habitat Datasets
(bevbert_ce/habitat_extensions/task.py:49-260) that
deserialize ``{split}.json.gz`` episode files plus, for RxR nDTW supervision,
``{split}_gt.json.gz`` role files (ss_trainer_BEV.py:637-643). Here episodes
are plain :class:`~vln_bevbert_tpu_torch.ce.env.CEEpisode` records consumed by
either the synthetic env or the habitat binding, so the loaders are pure
functions over the on-disk format — no registry, no attrs validators.

Format (R2R_VLNCE_v1-3 release):
  {"episodes": [{"episode_id", "trajectory_id", "scene_id",
                 "start_position" [3], "start_rotation" [4 quat wxyz... xyzw],
                 "goals": [{"position", "radius"}],
                 "reference_path": [[x,y,z], ...],
                 "instruction": {"instruction_text", "instruction_tokens"}},
                ...],
   "instruction_vocab": {"word_list": [...]}}
RxR adds per-role files and ``timed_instruction``; gt files map
episode_id -> {"locations": [[x,y,z]...], "actions": [...]}.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .env import CEEpisode
from .geometry_ce import heading_from_quaternion


def _load_json_gz(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _episode_heading(start_rotation: Sequence[float]) -> float:
    # habitat start_rotation is a quaternion [x, y, z, w]
    q = np.asarray(start_rotation, np.float64)
    return float(heading_from_quaternion(q))


def load_vlnce_episodes(
    data_path: str,
    tokenizer: Optional[Callable[[str], Sequence[int]]] = None,
    max_instr_len: int = 200,
    scenes: Optional[Sequence[str]] = None,
) -> List[CEEpisode]:
    """Parse a VLN-CE ``{split}.json.gz`` into CEEpisode records
    (ref VLNCEDatasetV1.from_json, task.py:106-133).

    ``tokenizer`` maps instruction text to ids; without one, the release's
    ``instruction_tokens`` are used as-is. ``scenes`` filters by scene name
    (the reference's get_scenes_to_load split sharding, task.py:64-77)."""
    raw = _load_json_gz(data_path)
    out: List[CEEpisode] = []
    for ep in raw["episodes"]:
        scene = os.path.basename(ep["scene_id"]).split(".")[0]
        if scenes is not None and scene not in scenes:
            continue
        instr = ep.get("instruction", {})
        if tokenizer is not None:
            enc = list(tokenizer(instr.get("instruction_text", "")))
        else:
            enc = list(instr.get("instruction_tokens", []))
        enc = np.asarray(enc[:max_instr_len], np.int32)
        ref_path = np.asarray(ep["reference_path"], np.float64)
        goals = ep.get("goals") or []
        goal = np.asarray(
            goals[0]["position"] if goals else ref_path[-1], np.float64
        )
        out.append(
            CEEpisode(
                episode_id=str(ep["episode_id"]),
                instr_encoding=enc,
                start_pos=np.asarray(ep["start_position"], np.float64),
                start_heading=_episode_heading(ep["start_rotation"]),
                gt_positions=ref_path,
                goal=goal,
            )
        )
    return out


def load_rxr_episodes(
    data_path_tmpl: str,
    roles: Sequence[str] = ("guide",),
    tokenizer: Optional[Callable[[str], Sequence[int]]] = None,
    max_instr_len: int = 200,
    languages: Optional[Sequence[str]] = None,
) -> List[CEEpisode]:
    """RxR-VLN-CE per-role episode files (ref RxRVLNCEDatasetV1.from_json,
    task.py:218-260). ``data_path_tmpl`` contains ``{role}``; episodes can be
    filtered by ``languages`` (e.g. ["en-US", "en-IN"])."""
    out: List[CEEpisode] = []
    for role in roles:
        raw = _load_json_gz(data_path_tmpl.format(role=role))
        for ep in raw["episodes"]:
            instr = ep.get("instruction", {})
            lang = instr.get("language")
            if languages is not None and lang is not None and not any(
                lang.startswith(l.split("-")[0]) for l in languages
            ):
                continue
            if tokenizer is not None:
                enc = list(tokenizer(instr.get("instruction_text", "")))
            else:
                enc = list(instr.get("instruction_tokens", []))
            ref_path = np.asarray(ep["reference_path"], np.float64)
            goals = ep.get("goals") or []
            goal = np.asarray(
                goals[0]["position"] if goals else ref_path[-1], np.float64
            )
            out.append(
                CEEpisode(
                    episode_id=str(ep["episode_id"]),
                    instr_encoding=np.asarray(enc[:max_instr_len], np.int32),
                    start_pos=np.asarray(ep["start_position"], np.float64),
                    start_heading=_episode_heading(ep["start_rotation"]),
                    gt_positions=ref_path,
                    goal=goal,
                )
            )
    return out


def load_gt_paths(
    gt_path_tmpl: str, roles: Sequence[str] = ("guide",)
) -> Dict[str, np.ndarray]:
    """``{split}_{role}_gt.json.gz`` -> {episode_id: (T,3) locations}; the
    nDTW reference paths (ref ss_trainer_BEV.py:637-643, 1192)."""
    gt: Dict[str, np.ndarray] = {}
    for role in roles:
        path = gt_path_tmpl.format(role=role) if "{role}" in gt_path_tmpl \
            else gt_path_tmpl
        raw = _load_json_gz(path)
        for ep_id, rec in raw.items():
            gt[str(ep_id)] = np.asarray(rec["locations"], np.float64)
        if "{role}" not in gt_path_tmpl:
            break
    return gt


def apply_gt_paths(episodes: List[CEEpisode], gt: Dict[str, np.ndarray]):
    """Replace each episode's sparse reference_path with the dense gt
    locations when available (the reference evaluates nDTW against gt
    locations, not the waypoint reference path)."""
    for ep in episodes:
        dense = gt.get(ep.episode_id)
        if dense is not None and len(dense) >= 2:
            ep.gt_positions = dense
    return episodes
