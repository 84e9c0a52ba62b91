"""jefferson_tpu_torch.viz"""
