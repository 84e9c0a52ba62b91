"""Device meshes, worlds of ranks and the collectives (``mesh``), and the
multi-process dryrun (``multihost``), on ``torch.distributed``."""
