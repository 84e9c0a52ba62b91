"""Convolution reverb: counterpart of ``jefferson_tpu.reverb``."""
