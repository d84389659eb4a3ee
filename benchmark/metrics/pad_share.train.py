"""The padded share of the frames that ``train_step`` was handed in the
window: each trial is padded to the fold's common bucket
(``data/datasets.py::frame_batch`` at ``train/loop.py::_common_bucket``).
Counted in the untraced window."""


def read(run):
    c = run.counters
    if not c.get("stepped_frames"):
        return None
    return 100.0 * (c["stepped_frames"] - c["real_frames"]) / c["stepped_frames"]
