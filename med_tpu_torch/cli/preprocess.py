"""Offline preprocessing driver (port of ``med_tpu.cli.preprocess``, the same
flags, printed lines and files; reference notebooks/data_processing.ipynb):
raw JIGSAWS kinematics txt + transcriptions + consensus error CSVs ->
per-trial .npz files + fold statistics.

Expected raw layout (JIGSAWS + error-annotation release):
  <raw>/kinematics/<Trial>.txt          76-column kinematics
  <raw>/transcriptions/<Trial>.txt      'start end G#' rows
  <raw>/errors/<Trial>.csv              OPTIONAL precomputed frame x 5 table
  <raw>/error_segments/<Trial>.json     OPTIONAL {error_name: [[s,e,v],…]}
  <raw>/consensus_errors/[<Task>/]…     OPTIONAL raw consensus release
                                        (Error_specific/G{i}_*.csv +
                                        error_{NP,S}_G{i}.csv), ingested via
                                        data/consensus.py (reference
                                        process_errors, preprocessing_utils
                                        .py:314-497)
  <raw>/features/<Trial>.npy            OPTIONAL (N, 2048) per-frame features
                                        (e.g. exported ResNet features)

Video decode (the reference's convert_videos_to_frames) is gated on a
decoder being present; pre-extracted features are the supported input here.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.consensus import find_consensus_folder, segments_from_consensus_csvs
from ..data.preprocessing import (
    TRIAL_GESTURE_PURGES,
    gestures_for_frames,
    parse_transcript_file,
    process_kinematics_array,
    purge_gestures,
    trial_purge_mask,
    errors_for_frames,
)
from ..data.trials import Trial, compute_fold_stats, save_fold_stats, save_trial_npz


def process_trial(raw_root: str, trial_name: str, frequency: int,
                  trial_purges=None) -> Trial:
    kin_raw = np.loadtxt(os.path.join(raw_root, "kinematics", trial_name + ".txt"))
    transcript = parse_transcript_file(
        os.path.join(raw_root, "transcriptions", trial_name + ".txt")
    )
    feats, frames = process_kinematics_array(kin_raw, frequency)

    gestures, covered = gestures_for_frames(transcript, frames)
    feats, frames = feats[covered], frames[covered]

    err_json = os.path.join(raw_root, "error_segments", trial_name + ".json")
    err_csv = os.path.join(raw_root, "errors", trial_name + ".csv")
    consensus_dir = find_consensus_folder(raw_root, trial_name)
    if os.path.exists(err_json):
        with open(err_json) as f:
            segments = {k: [tuple(r) for r in v] for k, v in json.load(f).items()}
        e_labels, keep = errors_for_frames(transcript, segments, frames)
        feats, frames, gestures = feats[keep], frames[keep], gestures[keep]
    elif consensus_dir is not None:
        segments = segments_from_consensus_csvs(consensus_dir, trial_name)
        e_labels, keep = errors_for_frames(transcript, segments, frames)
        feats, frames, gestures = feats[keep], frames[keep], gestures[keep]
    elif os.path.exists(err_csv):
        table = np.loadtxt(err_csv, delimiter=",", skiprows=1)
        frame_col = table[:, 0].astype(int)
        lookup = {f: row[1:6].astype(int) for f, row in zip(frame_col, table)}
        keep = np.asarray([f in lookup for f in frames])
        feats, frames, gestures = feats[keep], frames[keep], gestures[keep]
        e_labels = np.stack([lookup[f] for f in frames])
    else:
        e_labels = np.zeros((len(frames), 5), np.int64)

    keep = purge_gestures(gestures)  # drop gestures 10/11
    # per-trial corrupt-data purge (reference data_processing.ipynb "Delete
    # Gesture 9 from Needle_Passing_C005.pkl" cell): default rule drops all
    # gesture-9 frames from that one trial
    keep &= trial_purge_mask(trial_name, gestures, trial_purges)
    feats, frames, gestures, e_labels = (
        feats[keep], frames[keep], gestures[keep], e_labels[keep]
    )

    feat_file = os.path.join(raw_root, "features", trial_name + ".npy")
    if os.path.exists(feat_file):
        image_feats = np.load(feat_file)[: len(frames)].astype(np.float32)
    else:
        image_feats = np.zeros((len(frames), 2048), np.float32)

    return Trial(trial_name, image_feats, feats, gestures, e_labels, frames)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--raw-root", required=True)
    p.add_argument("--output-root", required=True)
    p.add_argument("--frequency", type=int, default=5)
    p.add_argument("--fold-spec", required=True,
                   help="JSON: {fold: {'train': [trials], 'test': [trials]}}")
    p.add_argument("--trial-purge", action="append", default=None,
                   metavar="TRIAL:G[,G…]",
                   help="per-trial gesture purge rule(s), e.g. "
                        "'Needle_Passing_C005:9' (the reference default); "
                        "pass 'none' to disable all per-trial purges")
    args = p.parse_args(argv)

    if args.trial_purge is None:
        trial_purges = TRIAL_GESTURE_PURGES
    elif args.trial_purge == ["none"]:
        trial_purges = {}
    else:
        trial_purges = {}
        for spec in args.trial_purge:
            name, _, gs = spec.partition(":")
            trial_purges[name] = tuple(int(g) for g in gs.split(",") if g)

    with open(args.fold_spec) as f:
        folds = json.load(f)

    trials = {}
    for fold, split in folds.items():
        for names in split.values():
            for t in names:
                if t not in trials:
                    print(f"processing {t}…")
                    trials[t] = process_trial(args.raw_root, t, args.frequency,
                                              trial_purges=trial_purges)

    for fold, split in folds.items():
        fold_dir = os.path.join(args.output_root, fold)
        os.makedirs(fold_dir, exist_ok=True)
        for split_name, names in split.items():
            with open(os.path.join(fold_dir, f"{split_name}.csv"), "w") as f:
                f.write("\n".join(n + ".npz" for n in names))
            for n in names:
                save_trial_npz(os.path.join(fold_dir, n + ".npz"), trials[n])
        tr_img = np.concatenate([trials[n].image_feats for n in split["train"]])
        tr_kin = np.concatenate([trials[n].kinematics for n in split["train"]])
        save_fold_stats(fold_dir, compute_fold_stats(tr_img, tr_kin))
        print(f"fold {fold}: {len(split['train'])} train / "
              f"{len(split['test'])} test trials")


if __name__ == "__main__":
    main()
