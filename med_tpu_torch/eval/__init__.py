"""Serving (port of ``med_tpu.eval``)."""
