"""SVD clutter filter of ultrasound slow-time ensembles (replaces
``stofnet_tpu/ops/svd_filter.py``).

The Casorati matrix (Fortran-order reshape, slow time last) of an IQ or
RF ensemble, its slow-time Gram matrix x^H x, the Gram's eigenvectors in
descending order (``torch.linalg.eigh`` flipped: the right singular
vectors of the reference's SVD), and the reconstruction from a band of
them. The band's projector ``u u^H`` is what is applied, so neither the
eigenvectors' signs (phases) nor the basis chosen inside a degenerate
eigenspace moves the result. complex64 and float32 inputs compute in
their own type, as in JAX; the same code runs on the CPU and the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _casorati(iq: torch.Tensor) -> torch.Tensor:
    """``np.reshape(iq, (-1, t), order='F')``: the space-major Casorati
    matrix, (space, t)."""
    t = iq.shape[-1]
    return iq.permute(*reversed(range(iq.ndim))).reshape(t, -1).T


def _uncasorati(x: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`_casorati` for an ensemble of ``shape``."""
    return x.T.reshape(tuple(reversed(shape))).permute(
        *reversed(range(len(shape))))


def _gram_eigh(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Descending (eigenvalues, eigenvectors) of the slow-time Gram matrix
    x^H x, the decomposition both filters share."""
    a = x.conj().T @ x  # (t, t) hermitian, positive semi-definite
    w, u = torch.linalg.eigh(a)  # ascending
    return w.flip(-1), u.flip(-1)


def svd_filter(iq: torch.Tensor, lo_cut: int = 4,
               hi_cut: int = -1) -> torch.Tensor:
    """Suppress tissue clutter: keep the singular components
    ``[lo_cut:hi_cut]`` of the slow-time ensemble (numpy slice semantics:
    the default -1 drops the last one too)."""
    shape = iq.shape
    x = _casorati(iq)
    _, u = _gram_eigh(x)
    v = x @ u
    n = v[:, lo_cut:hi_cut] @ u[:, lo_cut:hi_cut].conj().T
    return _uncasorati(n, shape)


def _levels_db(w: torch.Tensor) -> torch.Tensor:
    """Each singular value's level in dB relative to the principal one,
    from the descending Gram eigenvalues ``w`` (s = sqrt(w))."""
    s = torch.sqrt(torch.clamp(w, min=0.0))
    return 20.0 * torch.log10(s / s[0] + 1e-12)


def singular_levels_db(iq: torch.Tensor) -> torch.Tensor:
    """The slow-time ensemble's singular values in descending order, as
    the levels in dB relative to the principal one that
    :func:`svd_filter_db` compares with its threshold."""
    w, _ = _gram_eigh(_casorati(iq))
    return _levels_db(w)


def svd_filter_db(iq: torch.Tensor, clutter_db: float) -> torch.Tensor:
    """dB-threshold clutter filter: keep the singular components whose
    magnitude relative to the principal one lies below ``clutter_db``
    (:func:`singular_levels_db`)."""
    shape = iq.shape
    x = _casorati(iq)
    w, u = _gram_eigh(x)
    keep = (_levels_db(w) < clutter_db).to(u.dtype)
    n = (x @ (u * keep[None, :])) @ u.conj().T
    return _uncasorati(n, shape)
