"""The NumPy oracle (a copy of ``jefferson_tpu.oracle``)."""
