"""Embedding-family models of the port (port of ``lkpy_tpu.models``)."""
