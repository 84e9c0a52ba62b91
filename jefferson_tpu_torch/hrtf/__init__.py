"""The HRTF database and the KEMAR grid (copies of ``jefferson_tpu.hrtf``)."""
