"""Data plumbing the serving path needs (port of ``med_tpu.data``)."""
