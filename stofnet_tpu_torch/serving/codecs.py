"""Compact waveform input codecs, shared by both serving legs (a copy of
``stofnet_tpu/serving/codecs.py``).

A (128, 8000) request is 4 MB in f32, so the same quantization schemes
are offered on either leg:

- the TCP wire (``serving/tcp.py``'s SFN2 wire codes) encodes requests
  in the client and decodes them in the daemon;
- ``serve.make_pipeline(input_enc=...)`` takes (codes, scales) as its
  input, so the host-to-card copy ships the codes and the dequantization
  runs on the card.

Schemes (every encode is local to its waveform, so a request's decode is
independent of its batch composition, the invariant the int8 serving path
keeps too, ``models/int8.py``):

``s16``
    per-waveform symmetric int16, scale = max|row|/32767.
    2 B/sample + 4 B/row.
``s8c<n>`` (chunked int8)
    per-chunk symmetric int8: each row splits into ``n`` equal chunks,
    each with its own scale = max|chunk|/127, so a quiet chunk keeps a
    fine scale instead of riding the loudest echo's coarse one.
    1 B/sample + 4n B/row. ``n=1`` is the per-waveform scheme.

Dequantization is ``codes.astype(f32) * scale`` in float32 on both
sides; the numpy decode here and the torch dequantization of
``serve.make_pipeline`` give the same bits
(``tests/test_torch_serving.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# the wire's default s8c chunk count (the bare "s8c" spelling)
DEFAULT_CHUNKS = 16


def parse_s8c(name: str) -> Optional[int]:
    """``"s8c"``/``"s8c<n>"`` → chunk count (bare = DEFAULT_CHUNKS);
    None when the spelling is not an s8c scheme. The ONE parse both the
    TCP wire (tcp.parse_wire) and the input encodings
    (serve.parse_input_enc) share, so their accepted spellings can
    never drift apart."""
    if name == "s8c" or (name.startswith("s8c") and name[3:].isdigit()):
        n = int(name[3:]) if name[3:] else DEFAULT_CHUNKS
        if not 1 <= n <= 255:
            raise ValueError(f"s8c chunk count must be 1..255, got {n}")
        return n
    return None


def encode_s16(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(k, L) f32 → (codes (k, L) int16, scales (k,) f32); symmetric
    per-waveform, all-zero rows get scale 1.0 (no-op, matching
    ops/int8.absmax_scale's dead-row guard)."""
    rows = np.ascontiguousarray(rows, "<f4")
    amax = np.max(np.abs(rows), axis=-1)
    scales = np.where(amax > 0, amax / 32767.0, 1.0).astype("<f4")
    codes = np.clip(np.rint(rows / scales[:, None]), -32767,
                    32767).astype("<i2")
    return codes, scales


def decode_s16(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of encode_s16 up to quantization: (k, L) f32 rows."""
    return codes.astype("<f4") * np.asarray(scales, "<f4")[:, None]


def chunk_len(length: int, n_chunks: int) -> int:
    """Chunk size for ``s8c``: ``n_chunks`` must divide the waveform
    length (static serving contracts make this a config-time check)."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    if length % n_chunks:
        raise ValueError(f"n_chunks={n_chunks} must divide the waveform "
                         f"length {length}")
    return length // n_chunks


def encode_s8c(rows: np.ndarray, n_chunks: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(k, L) f32 → (codes (k, L) int8, scales (k, n_chunks) f32);
    symmetric per-chunk, all-zero chunks get scale 1.0."""
    rows = np.ascontiguousarray(rows, "<f4")
    k, length = rows.shape
    c = chunk_len(length, n_chunks)
    r = rows.reshape(k, n_chunks, c)
    amax = np.max(np.abs(r), axis=-1)
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype("<f4")
    codes = np.clip(np.rint(r / scales[..., None]), -127,
                    127).astype(np.int8)
    return codes.reshape(k, length), scales


def decode_s8c(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Inverse of encode_s8c up to quantization: (k, L) f32 rows."""
    k, length = codes.shape
    n = scales.shape[-1]
    c = chunk_len(length, n)
    r = codes.reshape(k, n, c).astype("<f4") * np.asarray(
        scales, "<f4")[..., None]
    return r.reshape(k, length)
