"""Feature-extraction models (counterpart of ``nct_tpu.models``)."""
