"""Carry the JAX package's state across to the port.

Each function takes NumPy arrays or anything ``np.asarray`` reads (a
``jax.Array`` too), so a render can start from the JAX package's filter
database and resume from overlap-save histories it produced.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EngineConfig
from .hrtf.kemar import HRTFDatabase


def database_from_numpy(spectra, hrirs, config_fields: dict, source: str = "converted") -> HRTFDatabase:
    """The port's ``HRTFDatabase`` and ``EngineConfig`` from a database's
    arrays (``db.spectra`` complex64, ``db.hrirs`` float32) and its
    config's fields (``dataclasses.asdict(db.config)``)."""
    return HRTFDatabase(
        hrirs=np.asarray(hrirs, np.float32), spectra=np.asarray(spectra, np.complex64),
        config=EngineConfig(**config_fields), source=source,
    )


def spectra_from_numpy(spectra, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``db.spectra`` (num_hrtf, 2, bins) complex64, or its (re, im) planes
    -> the (re, im) float32 planes on ``device`` that the JAX BatchRenderer
    builds in its constructor."""
    if isinstance(spectra, (tuple, list)):
        re, im = (np.asarray(a) for a in spectra)
    else:
        spectra = np.asarray(spectra)
        re, im = np.real(spectra), np.imag(spectra)
    return tuple(torch.tensor(a, dtype=torch.float32, device=device) for a in (re, im))


def hists_from_numpy(hists, device) -> torch.Tensor:
    """Overlap-save histories (S, history_len) -> float32 on ``device``."""
    return torch.tensor(np.asarray(hists), dtype=torch.float32, device=device)
