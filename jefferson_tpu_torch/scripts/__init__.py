"""The port's probe scripts, each run as ``python -m
jefferson_tpu_torch.scripts.<name>`` (the card unless ``--device cpu``):
``apply_assoc_probe`` (rows 9-11), ``bench_blend_variants`` (row 12) and
``error_budget``, counterparts of the JAX package's ``scripts/`` of the
same names."""
