"""Plane-split FFT and filter ops (torch counterparts of jefferson_tpu.ops)."""
