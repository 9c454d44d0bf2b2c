"""Compute ops of the port (counterparts of ``nct_tpu.ops``)."""
