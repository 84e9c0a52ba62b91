"""jefferson_tpu_torch.utils"""
