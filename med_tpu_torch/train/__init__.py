"""Eval-side engine and checkpoint I/O (port of ``med_tpu.train``)."""
