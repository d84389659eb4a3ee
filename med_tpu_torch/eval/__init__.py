"""Result aggregation and serving (port of ``med_tpu.eval``): frame-to-window
rollup, summary tables, ensembles, results, and the model servers."""

from .ensemble import cascade_ensemble, soft_vote  # noqa: F401
from .rollup import compute_window_metrics, frame_to_window  # noqa: F401
from .summary import create_summary, weighted_mean_std  # noqa: F401
