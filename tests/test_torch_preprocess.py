"""The port's offline JIGSAWS preprocessing against med_tpu's: the
kinematics, transcript and error-table functions, the raw consensus CSVs
(tests/test_consensus.py's goldens), the video readers and
``cli.preprocess`` of both packages on one synthetic raw layout (the same
trial files and fold statistics). Host-only numpy on both sides: every
output is compared for equality.
"""

import json
import os
import shutil

import numpy as np
import pytest

from med_tpu.cli import preprocess as jcli
from med_tpu.data import consensus as jcons
from med_tpu.data import preprocessing as jpre
from med_tpu_torch.cli import preprocess as tcli
from med_tpu_torch.data import consensus as tcons
from med_tpu_torch.data import preprocessing as tpre
from test_consensus import _write_csv, make_np_release, oracle_process_errors


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def _rot(x, y, z):
    cx, sx, cy, sy, cz, sz = np.cos(x), np.sin(x), np.cos(y), np.sin(y), np.cos(z), np.sin(z)
    return (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
            @ np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))


def test_kinematics_functions_equal_med_tpus(rng):
    """Euler angles (and the gimbal-lock branch), the 76 -> 26 column
    layout at 30 and 5 Hz."""
    Rs = np.stack([_rot(*a) for a in rng.uniform(-1.4, 1.4, size=(40, 3))]
                  + [_rot(0.3, np.pi / 2, 0.0)])
    _same(tpre.rotation_matrix_to_euler(Rs), jpre.rotation_matrix_to_euler(Rs))
    raw = rng.normal(size=(61, 76))
    for base in (41, 60):
        raw[:, base:base + 9] = np.stack([_rot(*a).ravel()
                                          for a in rng.uniform(-1, 1, size=(61, 3))])
    for hz in (30, 5):
        _same(tpre.process_kinematics_array(raw, hz), jpre.process_kinematics_array(raw, hz))
    with pytest.raises(ValueError, match="76 kinematic columns"):
        tpre.process_kinematics_array(raw[:, :70])


def test_transcript_functions_equal_med_tpus(rng, tmp_path):
    transcript = [(10, 19, 1), (20, 29, 2), (25, 34, 11), (40, 49, 3), (50, 60, 10)]
    frames = np.arange(1, 70, 3)
    _same(tpre.gestures_for_frames(transcript, frames),
          jpre.gestures_for_frames(transcript, frames))
    _same(tpre.trim_to_transcript(frames, transcript),
          jpre.trim_to_transcript(frames, transcript))
    segments = {"Out_Of_View": [(10, 19, 1)], "Error": [(10, 19, 1), (30, 39, 1)],
                "Needle_Drop": [(30, 39, 0), (12, 33, 1)], "Needle_Position": [(45, 80, 1)]}
    _same(tpre.errors_for_frames(transcript, segments, frames),
          jpre.errors_for_frames(transcript, segments, frames))
    g = rng.integers(1, 12, size=200)
    _same(tpre.purge_gestures(g), jpre.purge_gestures(g))
    _same(tpre.purge_gestures(g, (3, 9)), jpre.purge_gestures(g, (3, 9)))
    assert tpre.TRIAL_GESTURE_PURGES == jpre.TRIAL_GESTURE_PURGES
    for name, rules in (("Needle_Passing_C005", None), ("Needle_Passing_B001", None),
                        ("X", {"X": (3, 9)}), ("X", {})):
        _same(tpre.trial_purge_mask(name, g, rules), jpre.trial_purge_mask(name, g, rules))
    path = tmp_path / "t.txt"
    path.write_text("10 19 G1\n20 29 G12\n\n40 49 G3 extra\nbad\n")
    assert tpre.parse_transcript_file(str(path)) == jpre.parse_transcript_file(str(path))
    for name in ("Needle_Passing_B001_120_480.avi", "Suturing_C002_5_8.avi"):
        assert tpre.parse_segment_name(name) == jpre.parse_segment_name(name)
    with pytest.raises(ValueError, match="cannot parse"):
        tpre.parse_segment_name("Suturing_C002.avi")


def test_subsample_stream_equals_med_tpus():
    frames = list(range(100, 160))
    for hz in (1, 5, 6, 7, 30):
        assert list(tpre.subsample_stream(frames, hz)) == list(jpre.subsample_stream(frames, hz))
    with pytest.raises(ValueError, match="between 1 and 30"):
        list(tpre.subsample_stream(frames, 60))


def test_decoder_gated_error(monkeypatch):
    """Without OpenCV and ffmpeg the readers raise med_tpu's error."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no video decoder") as ours:
        tpre.decode_video_frames("/nonexistent.avi", 5)
    with pytest.raises(RuntimeError, match="no video decoder") as theirs:
        jpre.decode_video_frames("/nonexistent.avi", 5)
    assert str(ours.value) == str(theirs.value)


# ----------------------------------------------------------------- consensus
def test_np_consensus_golden_through_the_port(tmp_path):
    """tests/test_consensus.py's Needle-Passing release through the port:
    the literal oracle, and med_tpu's segments."""
    root = str(tmp_path / "np")
    make_np_release(root)
    transcript = [(10, 60, 1), (61, 100, 2)]
    kin_frames = np.arange(4, 121, 6)
    segments = tcons.segments_from_consensus_csvs(root, "Needle_Passing_B001")
    assert segments == jcons.segments_from_consensus_csvs(root, "Needle_Passing_B001")
    got, _ = tpre.errors_for_frames(transcript, segments, kin_frames)
    want = oracle_process_errors(root, "Needle_Passing_B001", "NP",
                                 tcons.ERROR_DICT_NEEDLE_PASSING, transcript, kin_frames)
    np.testing.assert_array_equal(got, want)


def test_suturing_consensus_and_folder_lookup(tmp_path):
    root = str(tmp_path / "consensus_errors" / "Suturing")
    es = os.path.join(root, "Error_specific")
    _write_csv(os.path.join(es, "G1_outofview.csv"), "files", [("Suturing_C002_5_8.avi", 1)])
    _write_csv(os.path.join(es, "G2_needledrop.csv"), "files",
              [("Suturing_C002_9_12.avi", 1), ("Suturing_D003_5_20.avi", 1)])
    _write_csv(os.path.join(root, "error_S_G1.csv"), "files", [("Suturing_C002_2_14.avi", 1)])
    transcript, kin_frames = [(2, 20, 3)], np.arange(1, 25)
    segments = tcons.segments_from_consensus_csvs(root, "Suturing_C002")
    assert segments == jcons.segments_from_consensus_csvs(root, "Suturing_C002")
    got, _ = tpre.errors_for_frames(transcript, segments, kin_frames)
    np.testing.assert_array_equal(got, oracle_process_errors(
        root, "Suturing_C002", "S", tcons.ERROR_DICT_SUTURING, transcript, kin_frames))
    raw = str(tmp_path)
    for trial in ("Suturing_C002", "Needle_Passing_B001"):
        assert (tcons.find_consensus_folder(raw, trial)
                == jcons.find_consensus_folder(raw, trial))
    assert tcons.find_consensus_folder(raw, "Suturing_C002") == root
    assert tcons.task_type_for_trial("Needle_Passing_B001") == "NP"


# ------------------------------------------------------------------- the CLI
def _raw_trial(root, name, rng, error_source, n30=600):
    """76-column kinematics at 30 Hz, a transcription (with gesture 11 and
    gesture 9 runs) and one error source: segments JSON, a frame table CSV,
    a consensus release, or none; features for some trials."""
    for d in ("kinematics", "transcriptions", "error_segments", "errors", "features"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    kin = rng.normal(size=(n30, 76))
    for base in (41, 60):
        kin[:, base:base + 9] = np.eye(3).ravel()
    np.savetxt(os.path.join(root, "kinematics", name + ".txt"), kin)
    rows = [(60, 179, 1), (180, 299, 2), (300, 359, 11), (360, 449, 3), (450, 540, 4),
            (541, 590, 9)]
    with open(os.path.join(root, "transcriptions", name + ".txt"), "w") as f:
        f.writelines(f"{s} {e} G{g}\n" for s, e, g in rows)
    if error_source == "json":
        with open(os.path.join(root, "error_segments", name + ".json"), "w") as f:
            json.dump({"Out_Of_View": [[180, 299, 1]], "Error": [[180, 299, 1], [360, 449, 1]],
                       "Multiple_Attempts": [[360, 449, 1]]}, f)
    elif error_source == "csv":
        table = np.zeros((n30, 6))
        table[:, 0] = np.arange(1, n30 + 1)
        table[200:260, 5] = 1
        table[::7, 2] = 1
        np.savetxt(os.path.join(root, "errors", name + ".csv"), table, delimiter=",",
                   header="frame,oov,nd,ma,np,err", comments="")
    elif error_source == "consensus":
        make_np_release(os.path.join(root, "consensus_errors", "Needle_Passing"))
    if error_source != "none":
        np.save(os.path.join(root, "features", name + ".npy"),
                rng.normal(size=(200, 2048)).astype(np.float32))


@pytest.mark.parametrize("purge", [[], ["--trial-purge", "none"],
                                   ["--trial-purge", "Needle_Passing_B001:2,3"]])
def test_preprocess_cli_writes_med_tpus_files(tmp_path, rng, purge):
    """Both packages' ``cli.preprocess.main`` on one raw layout (each error
    source, the corrupt trial's gesture-9 purge and its overrides): the
    same printed lines, trial files and ``stats.npz``, array for array."""
    raw = str(tmp_path / "raw")
    names = {"Needle_Passing_C005": "json", "Needle_Passing_B001": "consensus",
             "Needle_Passing_D002": "csv", "Suturing_E003": "none"}
    for name, source in names.items():
        _raw_trial(raw, name, rng, source)
    spec = {"1Out": {"train": list(names)[:3], "test": list(names)[3:]},
            "2Out": {"train": list(names)[1:], "test": list(names)[:1]}}
    spec_path = str(tmp_path / "folds.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    outs = {}
    for pkg, cli in (("port", tcli), ("med_tpu", jcli)):
        outs[pkg] = str(tmp_path / pkg)
        cli.main(["--raw-root", raw, "--output-root", outs[pkg], "--frequency", "5",
                  "--fold-spec", spec_path, *purge])
    for fold in spec:
        files = sorted(os.listdir(os.path.join(outs["med_tpu"], fold)))
        assert files == sorted(os.listdir(os.path.join(outs["port"], fold)))
        assert len(files) == len(names) + 3      # the trials, train.csv, test.csv, stats.npz
        for fname in files:
            a, b = (os.path.join(outs[p], fold, fname) for p in ("port", "med_tpu"))
            if fname.endswith(".csv"):
                assert open(a).read() == open(b).read()
                continue
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in zb.files:
                    assert za[k].dtype == zb[k].dtype, (fname, k)
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{fname} {k}")
    with np.load(os.path.join(outs["port"], "2Out", "Needle_Passing_C005.npz")) as z:
        # the default rule drops the corrupt trial's gesture 9; an override
        # replaces the rules
        assert (9 in z["g_labels"]) == bool(purge)
        assert not np.isin(z["g_labels"], [10, 11]).any()
