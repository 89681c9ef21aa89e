"""Reference-format annotation shims.

The fine-tune CLIs natively read ``{dataset}_{split}_enc.jsonl`` — one
already-split record per line with ``instr_id / scan / path / instr_encoding``.
The published BEVBert annotation releases use different shapes per dataset
(reference ``map_nav_src/*/data_utils.py``):

  r2r/r4r  ``R2R_{split}_enc.json``                 JSON list; one item per
           trajectory carrying ``instructions`` + ``instr_encodings`` lists
           (r2r/data_utils.py:6-39).
  rxr      ``rxr_{split}_guide_enc_xlmr.jsonl``     jsonlines; already split,
           keyed by ``instruction_id`` (r2r/data_utils.py:14-18, 44-52).
  reverie  ``REVERIE_{split}_enc.json`` (bert) or ``REVERIE_{split}_enc_xlmr
           .json`` (xlm) — JSON list with ``objId`` targets
           (reverie/data_utils.py:56-93).
  soon     ``bert_enc/{split}_enc_pseudo_obj_label.jsonl`` falling back to
           ``bert_enc/{split}_enc.jsonl`` — jsonlines with per-instruction
           dicts keyed by ``instr_type`` and bbox pseudo-labels
           (soon/data_utils.py:27-69).

This module loads EITHER format unconverted: file resolution tries the native
name first, then the reference names; per-item schema sniffing (``instructions``
present → reference multi-instruction item) handles augmented files passed by
explicit path regardless of their name.  ``construct_instrs`` reproduces the
reference's splitting/id rules so downstream envs see identical records either
way.  Note: the reference's own loader only codes the ``R2R_`` filename and
r4r would fall through (r2r/data_utils.py:10-19); we accept ``R4R_{split}_
enc.json`` too.
"""

from __future__ import annotations

import copy
import json
import os
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "read_annotation_file",
    "resolve_annotation_file",
    "load_instr_datasets",
    "construct_instrs",
]


def read_annotation_file(path: str) -> List[dict]:
    """Read a ``.json`` (list) or ``.jsonl``/``jsonlines`` annotation file."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, list):
            raise ValueError(f"{path}: expected a JSON list of items")
        return data
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            if line.strip():
                out.append(json.loads(line))
    return out


def _candidate_names(dataset: str, split: str, tokenizer: str) -> List[str]:
    d = dataset.lower()
    names = [f"{d}_{split}_enc.jsonl"]  # native format, always first
    if d in ("r2r", "r4r"):
        # reference codes only the R2R_ name even for r4r (data_utils.py:11)
        names += [f"{d.upper()}_{split}_enc.json", f"R2R_{split}_enc.json"]
    elif d == "rxr":
        names += [f"rxr_{split}_guide_enc_xlmr.jsonl"]
    elif d == "reverie":
        if tokenizer == "xlm":
            names += [f"REVERIE_{split}_enc_xlmr.json"]
        else:
            names += [f"REVERIE_{split}_enc.json"]
    elif d == "soon":
        names += [
            os.path.join("bert_enc", f"{split}_enc_pseudo_obj_label.jsonl"),
            os.path.join("bert_enc", f"{split}_enc.jsonl"),
        ]
    return names


def resolve_annotation_file(
    anno_dir: str, dataset: str, split: str, tokenizer: str = "bert"
) -> str:
    """Find the annotation file for ``split``, native name first then the
    reference release names.  Raises FileNotFoundError listing what was tried."""
    tried = []
    for name in _candidate_names(dataset, split, tokenizer):
        path = os.path.join(anno_dir, name)
        tried.append(path)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no {dataset} annotations for split '{split}' under {anno_dir}; "
        f"tried: {', '.join(tried)}"
    )


def _normalize_soon_item(item: dict) -> dict:
    """SOON raw records carry a bbox list; index it by image_id and derive the
    end-image / pseudo-label tables (ref soon/data_utils.py:39-45)."""
    if "bboxes" in item and isinstance(item["bboxes"], list):
        item = dict(item)
        item["end_image_ids"] = [x["image_id"] for x in item["bboxes"]]
        item["image_id_to_obj_label"] = {
            x["image_id"]: x.get("pseudo_label", None) for x in item["bboxes"]
        }
        item["bboxes"] = {x["image_id"]: x for x in item["bboxes"]}
    return item


def load_instr_datasets(
    anno_dir: str,
    dataset: str,
    splits: Sequence[str],
    tokenizer: str = "bert",
    is_test: bool = True,
    rng: Optional[np.random.Generator] = None,
) -> List[dict]:
    """Load raw annotation items for each split.

    A split containing a path separator is treated as an explicit file path
    (the reference's augmented-data convention, r2r/data_utils.py:25-35);
    otherwise the file is resolved under ``anno_dir``.  r4r val_unseen is
    subsampled to 200 when not ``is_test`` (r2r/data_utils.py:21-24).
    """
    d = dataset.lower()
    data: List[dict] = []
    for split in splits:
        if os.sep in split or "/" in split:
            new_data = read_annotation_file(split)
        else:
            path = resolve_annotation_file(anno_dir, dataset, split, tokenizer)
            new_data = read_annotation_file(path)
            if not is_test and d == "r4r" and split == "val_unseen":
                r = rng if rng is not None else np.random.default_rng(0)
                ridxs = r.permutation(len(new_data))[:200]
                new_data = [new_data[i] for i in ridxs]
        if d == "soon":
            new_data = [_normalize_soon_item(x) for x in new_data]
        data += new_data
    return data


def _split_item(item: dict, dataset: str, instr_type: str,
                max_instr_len: int) -> List[dict]:
    """Expand one reference multi-instruction item into per-instruction
    records, reproducing the reference's instr_id rules."""
    d = dataset.lower()
    out = []
    for j, instr in enumerate(item["instructions"]):
        new_item = copy.deepcopy(item) if d == "soon" else dict(item)
        if d == "soon":
            # per-instruction dicts keyed by instr_type (soon/data_utils.py:61-65)
            new_item["instr_id"] = "%s_%d" % (item["path_id"], j)
            new_item["instruction"] = instr[instr_type]
            new_item["instr_encoding"] = (
                item["instr_encodings"][j][instr_type][:max_instr_len]
            )
        elif d == "reverie":
            # objId joins the id; non-object items fall back to item['id']
            # (reverie/data_utils.py:79-86)
            if "objId" in item:
                new_item["instr_id"] = "%s_%s_%d" % (
                    str(item["path_id"]), str(item["objId"]), j)
            else:
                new_item["path_id"] = item["id"]
                new_item["instr_id"] = "%s_%d" % (item["id"], j)
                new_item["objId"] = None
            new_item["instruction"] = instr
            new_item["instr_encoding"] = item["instr_encodings"][j][:max_instr_len]
        else:  # r2r / r4r (r2r/data_utils.py:54-62)
            new_item["instr_id"] = "%s_%d" % (item["path_id"], j)
            new_item["instruction"] = instr
            new_item["instr_encoding"] = item["instr_encodings"][j][:max_instr_len]
        del new_item["instructions"]
        del new_item["instr_encodings"]
        out.append(new_item)
    return out


def construct_instrs(
    anno_dir: str,
    dataset: str,
    splits: Sequence[str],
    max_instr_len: int = 512,
    tokenizer: str = "bert",
    is_test: bool = True,
    instr_type: str = "full",
    rng: Optional[np.random.Generator] = None,
) -> List[dict]:
    """Load splits and emit per-instruction records in the internal shape.

    Schema sniff per item: an item with ``instructions`` is a reference
    multi-instruction record and gets split; an item already carrying
    ``instr_encoding`` (native jsonl, or RxR guide files) passes through with
    only the RxR id normalisation (r2r/data_utils.py:44-52).
    """
    d = dataset.lower()
    data: List[dict] = []
    for item in load_instr_datasets(
        anno_dir, dataset, splits, tokenizer, is_test=is_test, rng=rng
    ):
        if "instructions" in item:
            data.extend(_split_item(item, dataset, instr_type, max_instr_len))
        else:
            new_item = dict(item)
            if d == "rxr" and "instruction_id" in item and "instr_id" not in item:
                if "path_id" in item:
                    new_item["instr_id"] = "%d_%d" % (
                        item["path_id"], item["instruction_id"])
                else:  # test split has no path_id
                    new_item["path_id"] = new_item["instr_id"] = str(
                        item["instruction_id"])
            if "instr_encoding" in new_item:
                new_item["instr_encoding"] = (
                    new_item["instr_encoding"][:max_instr_len]
                )
            data.append(new_item)
    return data
