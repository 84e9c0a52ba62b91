"""jefferson_tpu_torch.rt"""
from .playout import AudioPlayout, BlockStats, have_output_device
