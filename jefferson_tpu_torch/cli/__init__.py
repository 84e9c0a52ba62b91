"""The file-to-file CLI: counterpart of ``jefferson_tpu.cli``."""
