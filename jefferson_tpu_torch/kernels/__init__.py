"""Hand-written Hopper kernels (counterparts of jefferson_tpu.pallas), each
beside its plain-PyTorch twin, and the nvcc build that loads them."""
