"""jefferson_tpu_torch.io"""
