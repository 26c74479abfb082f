"""Spatial domain decomposition (counterpart of `waterlily_tpu.parallel`)."""
