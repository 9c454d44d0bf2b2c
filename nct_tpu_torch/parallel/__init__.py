"""Geometry buckets and batch transfer (counterpart of ``nct_tpu.parallel``)."""
