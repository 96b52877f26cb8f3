"""Zip extraction for dataset archives (the port's own copy of
``stofnet_tpu/utils/zip_extract.py``): a ``data_dir`` ending in .zip is
extracted next to itself once, then used as a directory.
"""

from __future__ import annotations

import zipfile
from pathlib import Path


def zip_extract(path: str | Path) -> Path:
    """Extract ``<name>.zip`` to its parent dir (idempotent); returns the
    extracted data directory.

    The archive's actual top-level directory is detected from its entries
    (it need not match the zip stem). Archives whose entries sit at the
    root extract into ``<name>/``.
    """
    path = Path(path)
    fallback = path.with_suffix("")
    if not str(path).lower().endswith(".zip") or not path.exists():
        return fallback
    with zipfile.ZipFile(path) as zf:
        names = [n for n in zf.namelist() if n and not n.startswith("__MACOSX")]
        roots = {n.split("/", 1)[0] for n in names}
        if len(roots) == 1 and all("/" in n for n in names):
            target = path.parent / next(iter(roots))
            if not target.exists():
                zf.extractall(path.parent)
            return target
        # flat archive: extract under <name>/
        if not fallback.exists():
            zf.extractall(fallback)
    return fallback
