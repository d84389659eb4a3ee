"""Command-line drivers of the port (counterparts of ``med_tpu.cli``)."""
