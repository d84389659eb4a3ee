"""Raw consensus error-label ingestion (JIGSAWS error-annotation release;
the port's copy of ``med_tpu.data.consensus``, host-only).

Reproduces the reference's ``process_errors`` joins
(MED/dataset/preprocessing_utils.py:314-497): for each trial, the five error
columns are populated from the release's per-gesture consensus CSVs —

  <folder_errors>/Error_specific/G{i}_{error_name}.csv  (specific errors)
  <folder_errors>/error_{task}_G{i}.csv                 (global 'Error')

each with a ``name`` (Needle Passing) / ``files`` (Suturing) column holding
``<trial>_<start>_<end>.avi`` segment names and a ``label_err1_nor0`` column.

Reference quirks reproduced deliberately:
- Needle-Passing name munging (preprocessing_utils.py:395-404, :445-452):
  the specific-error CSVs (except Multiple_Attempts) name trials
  ``NeedlePassing_X`` (no underscore), while the attempts CSVs and the
  global error CSVs use ``Needle_Passing_X``;
- trial match is a *substring* test against the segment name, start/end are
  parsed from ``_<start>_`` and ``_<end>.avi`` (:423-430);
- later rows/files overwrite earlier ones on overlapping segments (the
  ``.loc`` assignment order, :433), including explicit 0 labels;
- frames no CSV covers are zero-filled (``fillna(0)``, :482).

Deviation (documented): the reference iterates ``os.listdir`` in filesystem
order; files are sorted here so the later-wins semantics are deterministic.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

from .preprocessing import parse_segment_name

# error column -> substring identifying its CSVs (data_processing.ipynb cell 10)
ERROR_DICT_NEEDLE_PASSING = {
    "Out_Of_View": "OutofView",
    "Needle_Drop": "Needledrop",
    "Multiple_Attempts": "attempts",
    "Needle_Position": "needle_position",
    "Error": "error",
}
ERROR_DICT_SUTURING = {
    "Out_Of_View": "outofview",
    "Needle_Drop": "needledrop",
    "Multiple_Attempts": "attempts",
    "Needle_Position": "position",
    "Error": "error",
}


def task_type_for_trial(trial_name: str) -> str:
    return "NP" if trial_name.startswith("Needle_Passing") else "S"


def _matching_files(folder: str, predicate) -> List[str]:
    if not os.path.isdir(folder):
        return []
    return sorted(f for f in os.listdir(folder) if predicate(f))


def segments_from_consensus_csvs(
    folder_errors: str,
    trial_name: str,
    task_type: Optional[str] = None,
    error_dict: Optional[Dict[str, str]] = None,
) -> Dict[str, List[Tuple[int, int, int]]]:
    """One trial's labeled segments from the raw consensus release.

    Returns ``{error_column: [(start, end, value), …]}`` in the reference's
    paint order, ready for :func:`med_tpu_torch.data.preprocessing.errors_for_frames`
    (whose sequential painting reproduces the later-wins overwrite).
    """
    if task_type is None:
        task_type = task_type_for_trial(trial_name)
    if error_dict is None:
        error_dict = (ERROR_DICT_NEEDLE_PASSING if task_type == "NP"
                      else ERROR_DICT_SUTURING)
    column = "name" if task_type == "NP" else "files"

    segments: Dict[str, List[Tuple[int, int, int]]] = {}
    for error, error_name in error_dict.items():
        if error != "Error":
            folder = os.path.join(folder_errors, "Error_specific")
            files = _matching_files(
                folder, lambda f: error_name in f and f.endswith(".csv"))
        else:
            folder = folder_errors
            files = _matching_files(
                folder,
                lambda f: f.startswith(f"error_{task_type}") and f.endswith(".csv"),
            )
        # Needle-Passing naming: no-underscore form for specific errors
        # except attempts; underscore form for attempts + global Error
        if task_type == "NP" and error != "Error" and error_name != "attempts":
            munged = trial_name.replace("Needle_Passing", "NeedlePassing")
        else:
            munged = trial_name

        segs: List[Tuple[int, int, int]] = []
        for fname in files:
            with open(os.path.join(folder, fname), newline="") as f:
                for row in csv.DictReader(f):
                    name = row.get(column) or ""
                    if munged in name:
                        start, end = parse_segment_name(name)
                        segs.append(
                            (start, end, int(float(row["label_err1_nor0"])))
                        )
        if segs:
            segments[error] = segs
    return segments


def find_consensus_folder(raw_root: str, trial_name: str) -> Optional[str]:
    """Locate the consensus release for a trial under ``raw_root``:
    ``consensus_errors/<Task>/`` (per-task, the release's own layout) or a
    flat ``consensus_errors/`` holding Error_specific directly."""
    task_dir = "Needle_Passing" if task_type_for_trial(trial_name) == "NP" \
        else "Suturing"
    per_task = os.path.join(raw_root, "consensus_errors", task_dir)
    if os.path.isdir(os.path.join(per_task, "Error_specific")):
        return per_task
    flat = os.path.join(raw_root, "consensus_errors")
    if os.path.isdir(os.path.join(flat, "Error_specific")):
        return flat
    return None
