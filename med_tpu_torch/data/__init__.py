"""Host-side data pipeline (port of ``med_tpu.data``): preprocessing, fold
loading, windowing, the label powerset and the datasets."""

from ..config import compute_window_size_stride  # noqa: F401
from .labels import powerset_error_labels, select_error_labels  # noqa: F401
from .windowing import window_data, window_scan  # noqa: F401
