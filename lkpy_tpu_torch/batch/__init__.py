"""Batch recommendation on the device (port of ``lkpy_tpu.batch``)."""
