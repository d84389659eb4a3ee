"""Offline JIGSAWS preprocessing (port of ``med_tpu.data.preprocessing``,
reference MED/dataset/preprocessing_utils.py): host-only numpy transforms of
the raw kinematics, transcriptions and error segments, the video readers,
and the frame pixels for the ResNet-50 trunk.

- kinematics: of the 76 JIGSAWS columns keep the slave block (cols 39-76,
  1-based), convert each arm's 3x3 rotation matrix to Euler roll/pitch/yaw ->
  26 features ordered [xyz, rpy, vel xyz, rotvel xyz, grip] per arm; 30 Hz ->
  N Hz by keeping every (30//N)-th row; frame numbers are 1-based
  (preprocessing_utils.py:120-234);
- gestures: expand (start, end, G#) transcription rows into a per-frame
  integer vector for the kinematics frames covered by the transcription
  (:239-310);
- errors: per-trial frame x 5 table [OOV, ND, MA, NP, Error] built by
  painting labeled trial segments over the transcription range, NaN->0,
  subsampled to the kinematics frames (:314-497);
- alignment: drop frames outside the transcription range (:501-583), purge
  gestures 10/11 everywhere (:587-683), and the per-trial corrupt-data purge;
- video: decode through OpenCV or an ffmpeg pipe, keeping the reference's
  count-based subsample rule; without a decoder the readers raise;
- frame pixels: bilinear resize to 240, centre crop to 224, /255, ImageNet
  normalisation, as the reference's frame pipeline does. The resize is a
  linear map per axis, so it runs as two fp32 matmuls against exact resize
  matrices; the crop is folded into the matrices and /255 plus the
  normalisation into one affine. A 240-long axis resizes to itself, so it
  is a plain crop.

``med_tpu``'s ``preprocess_frames_native`` (its C++ host helper) has no copy
here: :func:`preprocess_frames` is its counterpart. ``decode_preprocess_batches``
feeds it through the double-buffered ``utils/prefetch.py``.
"""

from __future__ import annotations

import functools
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RAW_ERROR_COLUMNS

# slave kinematics block: 0-based column offsets into the 76-col file
_SLAVE_START = 38  # col 39 (1-based)


def rotation_matrix_to_euler(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) rotation matrices -> (..., 3) [roll, pitch, yaw] radians.

    Matches reference rotation_matrix_to_euler_angles
    (preprocessing_utils.py:90-117) including the gimbal-lock branch.
    """
    R = np.asarray(R, np.float64)
    sy = np.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = np.where(
        singular,
        np.arctan2(-R[..., 1, 2], R[..., 1, 1]),
        np.arctan2(R[..., 2, 1], R[..., 2, 2]),
    )
    y = np.arctan2(-R[..., 2, 0], sy)
    z = np.where(singular, 0.0, np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return np.stack([x, y, z], axis=-1)


def process_kinematics_array(
    raw: np.ndarray, frequency: int = 30
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 76) raw kinematics -> ((M, 26) features, (M,) 1-based frames)."""
    raw = np.asarray(raw, np.float64)
    if raw.shape[1] != 76:
        raise ValueError(f"expected 76 kinematic columns, got {raw.shape[1]}")
    slave = raw[:, _SLAVE_START : _SLAVE_START + 38]

    def arm(block):
        xyz = block[:, 0:3]
        R = block[:, 3:12].reshape(-1, 3, 3)
        rpy = rotation_matrix_to_euler(R)
        vel = block[:, 12:15]
        rotvel = block[:, 15:18]
        grip = block[:, 18:19]
        return np.concatenate([xyz, rpy, vel, rotvel, grip], axis=1)

    feats = np.concatenate([arm(slave[:, :19]), arm(slave[:, 19:])], axis=1)
    frames = np.arange(1, len(feats) + 1)
    if frequency != 30:
        step = 30 // frequency
        feats = feats[::step]
        frames = frames[::step]
    return feats.astype(np.float32), frames


def gestures_for_frames(
    transcript: Sequence[Tuple[int, int, int]], frames: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame gesture ints for the given frame numbers.

    Returns (gesture_vector, covered_mask): frames outside every
    transcription row are *skipped* (not zero-filled), matching reference
    process_gestures (:286-297); covered_mask marks which input frames got a
    gesture.
    """
    frames = np.asarray(frames)
    gestures = np.zeros(len(frames), np.int64)
    covered = np.zeros(len(frames), bool)
    for start, end, g in transcript:
        sel = (frames >= start) & (frames <= end) & ~covered
        gestures[sel] = g
        covered[sel] = True
    return gestures[covered], covered


def errors_for_frames(
    transcript: Sequence[Tuple[int, int, int]],
    segments: Dict[str, List[Tuple[int, int, int]]],
    frames: np.ndarray,
) -> np.ndarray:
    """(len(frames), 5) error table.

    ``segments``: error column name -> list of (start, end, value) labeled
    trial segments (the reference extracts start/end from consensus-CSV
    names like Needle_Passing_B001_120_480.avi, :423-430). Later segments
    overwrite earlier ones on overlap (the reference's .loc assignment
    order); unlabeled frames are 0 (fillna, :482).
    """
    frames = np.asarray(frames)
    start_t = min(s for s, _, _ in transcript)
    end_t = max(e for _, e, _ in transcript)
    out = np.zeros((len(frames), len(RAW_ERROR_COLUMNS)), np.int64)
    keep = (frames >= start_t) & (frames <= end_t)
    for col, name in enumerate(RAW_ERROR_COLUMNS):
        for s, e, value in segments.get(name, ()):
            sel = (frames >= s) & (frames <= e)
            out[sel, col] = value
    return out[keep], keep


def trim_to_transcript(
    frames: np.ndarray, transcript: Sequence[Tuple[int, int, int]]
) -> np.ndarray:
    """Mask of frames inside [min start, max end] (reference
    delete_unmatched_* :501-583)."""
    frames = np.asarray(frames)
    start_t = min(s for s, _, _ in transcript)
    end_t = max(e for _, e, _ in transcript)
    return (frames >= start_t) & (frames <= end_t)


def purge_gestures(
    gestures: np.ndarray, remove: Tuple[int, ...] = (10, 11)
) -> np.ndarray:
    """Keep-mask dropping the removed gesture ids (reference
    delete_gesture_frames/vectors :587-683)."""
    g = np.asarray(gestures)
    return ~np.isin(g, remove)


# Per-trial corrupt-data purges. The reference post-processes the packaged
# fold data and deletes every gesture-9 frame from the one corrupt trial
# (notebooks/data_processing.ipynb "Delete Gesture 9 from
# Needle_Passing_C005.pkl" cell: indices_to_delete = [i for i, g in
# enumerate(data['g_labels']) if g == 9], applied to every key in every
# fold). Here the same rule is applied at trial-packaging time, which lands
# on identical fold contents since the purge is per-trial.
TRIAL_GESTURE_PURGES: Dict[str, Tuple[int, ...]] = {
    "Needle_Passing_C005": (9,),
}


def trial_purge_mask(
    trial_name: str,
    gestures: np.ndarray,
    trial_purges: Optional[Dict[str, Tuple[int, ...]]] = None,
) -> np.ndarray:
    """Keep-mask for a trial's per-trial gesture purge (identity mask for
    trials with no rule). ``trial_purges`` defaults to the reference's
    :data:`TRIAL_GESTURE_PURGES`."""
    if trial_purges is None:
        trial_purges = TRIAL_GESTURE_PURGES
    remove = trial_purges.get(trial_name)
    g = np.asarray(gestures)
    if not remove:
        return np.ones(g.shape, bool)
    return ~np.isin(g, tuple(remove))


def parse_transcript_file(path: str) -> List[Tuple[int, int, int]]:
    """'start end G#' rows -> [(start, end, gesture_int)]."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                rows.append(
                    (int(parts[0]), int(parts[1]), int(parts[2].replace("G", "")))
                )
    return rows


def parse_segment_name(name: str) -> Tuple[int, int]:
    """'..._<start>_<end>.avi' -> (start, end) (reference :423-424)."""
    start = re.search(r"_(\d+)_", name)
    end = re.search(r"_(\d+)\.avi", name)
    if not start or not end:
        raise ValueError(f"cannot parse segment frames from {name!r}")
    return int(start.group(1)), int(end.group(1))


# ------------------------------------------------------------------ pixels
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@functools.lru_cache(maxsize=None)
def _resize_crop_matrix(n_in: int, n_out: int, lo: int, hi: int) -> np.ndarray:
    """(n_in, hi-lo) matrix M with M[i, k] = weight of input pixel i in
    output pixel lo+k of a bilinear resize from n_in to n_out pixels, as
    ``jax.image.resize(..., "bilinear")`` computes it (its
    ``compute_weight_mat``, in float32): a triangle kernel, widened by
    1/scale when downsampling (antialiasing), normalised per output pixel,
    zero where the sample point falls outside the input. An axis whose
    length does not change is the identity, as jax skips it."""
    if n_in == n_out:
        out = np.eye(n_in, dtype=np.float32)[:, lo:hi]
    else:
        scale = np.float32(n_out / n_in)
        inv_scale = np.float32(1.0) / scale
        kernel_scale = max(inv_scale, np.float32(1.0))
        sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale
                  - np.float32(0.5))
        x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
        w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
        total = w.sum(axis=0, keepdims=True, dtype=np.float32)
        w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                     w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
        inside = (sample >= -0.5) & (sample <= n_in - 0.5)
        out = np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)[:, lo:hi]
        out = np.ascontiguousarray(out)
    # the cache hands the same array to every caller: freeze it
    out.flags.writeable = False
    return out


def preprocess_frames(frames: torch.Tensor, mean=IMAGENET_MEAN,
                      std=IMAGENET_STD) -> torch.Tensor:
    """(N, H, W, 3) raw frames (uint8 or float) -> (N, 224, 224, 3) fp32:
    bilinear resize to 240, centre crop 224, /255, normalise; on the
    frames' device."""
    x = frames.to(torch.float32)
    _, h, w, _ = x.shape
    dev = x.device
    if h == 240:
        x = x[:, 8:232]
    else:
        rh = torch.from_numpy(np.array(_resize_crop_matrix(h, 240, 8, 232))).to(dev)
        x = torch.einsum("nhwc,hp->npwc", x, rh)
    if w == 240:
        x = x[:, :, 8:232]
    else:
        rw = torch.from_numpy(np.array(_resize_crop_matrix(w, 240, 8, 232))).to(dev)
        x = torch.einsum("nhwc,wq->nhqc", x, rw)
    std = np.asarray(std, np.float32)
    scale = torch.from_numpy((1.0 / (255.0 * std)).astype(np.float32)).to(dev)
    shift = torch.from_numpy((-np.asarray(mean, np.float32) / std).astype(np.float32)).to(dev)
    return x * scale + shift


def subsample_stream(frames_iter, frequency: int = 30):
    """Yield (frame_count, frame) pairs kept by the reference's subsample
    rule: 1-based ``frame_count % (30 / frequency) == 1``
    (preprocessing_utils.py:59-64 — float modulo, so frames 1, 1+step, …).
    ``frequency == 30`` keeps everything."""
    if not (1 <= frequency <= 30):
        raise ValueError("frequency must be between 1 and 30 Hz")
    step = 30 / frequency
    count = 1
    for frame in frames_iter:
        if frequency == 30 or count % step == 1:
            yield count, frame
        count += 1


def _ffmpeg_frame_stream(path: str, frequency: int):
    """Stream RGB frames through an ffmpeg raw-video pipe (no full-file
    buffering): ffprobe for dimensions, then fixed-size reads off the pipe."""
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    ffprobe = shutil.which("ffprobe")
    if not ffmpeg or not ffprobe:
        raise RuntimeError(
            "no video decoder available (cv2/ffmpeg missing); "
            "provide pre-extracted frames instead"
        )
    probe = subprocess.run(
        [ffprobe, "-v", "quiet", "-select_streams", "v:0", "-show_entries",
         "stream=width,height", "-of", "csv=p=0", path],
        capture_output=True, text=True, check=True,
    )
    w, h = map(int, probe.stdout.strip().split(","))
    proc = subprocess.Popen(
        [ffmpeg, "-i", path, "-f", "rawvideo", "-pix_fmt", "rgb24", "-v",
         "quiet", "-"],
        stdout=subprocess.PIPE,
    )
    nbytes = w * h * 3

    def gen():
        try:
            while True:
                buf = proc.stdout.read(nbytes)
                if buf is None or len(buf) < nbytes:
                    break
                yield np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        finally:
            proc.stdout.close()
            proc.wait()

    return (f for _, f in subsample_stream(gen(), frequency))


def iter_video_frames(path: str, frequency: int = 30):
    """Stream decoded RGB frames at ``frequency``: OpenCV if importable,
    else the ffmpeg pipe. Both share :func:`subsample_stream`, so the
    reference's count-based keep rule holds either way."""
    try:
        import cv2  # type: ignore
    except ImportError:
        return _ffmpeg_frame_stream(path, frequency)

    def gen():
        cap = cv2.VideoCapture(path)
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                yield frame[..., ::-1]  # BGR -> RGB
        finally:
            cap.release()

    return (f for _, f in subsample_stream(gen(), frequency))


def decode_video_frames(path: str, frequency: int = 30):
    """Materialize a whole trial's frames (N, H, W, 3) uint8 (reference
    convert_videos_to_frames, preprocessing_utils.py:46-84, minus the
    per-frame PNG writes — downstream consumes arrays)."""
    frames = list(iter_video_frames(path, frequency))
    return np.stack(frames) if frames else np.empty((0, 0, 0, 3), np.uint8)


def decode_preprocess_batches(path: str, frequency: int = 30, batch: int = 64,
                              depth: int = 2, frames_iter=None, device=None):
    """Decode -> fixed-size host batches -> double-buffered transfer to
    ``device`` (CUDA unless the caller passes ``device="cpu"``) -> the
    resize/crop/normalise graph: yields (n, 224, 224, 3) float32 tensors on
    the device, ready for the ResNet trunk (``med_tpu``'s
    ``decode_preprocess_batches``). ``frames_iter`` overrides the decoder
    for pre-extracted frame streams."""
    from ..utils.device import resolve_device
    from ..utils.prefetch import prefetch_to_device

    dev = resolve_device(device)
    source = frames_iter if frames_iter is not None else iter_video_frames(path, frequency)

    def host_batches():
        buf = []
        for f in source:
            buf.append(f)
            if len(buf) == batch:
                yield {"frames": np.stack(buf)}
                buf = []
        if buf:
            yield {"frames": np.stack(buf)}

    for b in prefetch_to_device(host_batches(), depth=depth, device=dev):
        yield preprocess_frames(torch.as_tensor(b["frames"], device=dev))
