"""Plotting utilities (port of ``med_tpu.viz``; reference
MED/visualization/utils.py). matplotlib is imported when a plot is made,
not with the package."""

from .utils import plot_cm, plot_results_LOSO  # noqa: F401
