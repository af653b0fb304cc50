"""Filesystem checks used by example/bench scripts.

Source-compatible with the reference's pycylon.util.FileUtils
(reference: python/pycylon/util/FileUtils.py:20-40 — ``path_exists``
raising on a None path, ``files_exist`` verifying a fileset under a
directory); rewritten.
"""
from __future__ import annotations

import os
from typing import List, Optional


def path_exists(path: Optional[str] = None) -> bool:
    """True iff ``path`` exists; a ``None`` path is an error, matching the
    reference's contract."""
    if path is None:
        raise ValueError("Directory path is None")
    return os.path.exists(path)


def files_exist(dir_path: Optional[str] = None, files: List = []) -> None:
    """Verify every name in ``files`` exists under ``dir_path``; raises
    ValueError naming the first missing file (reference behavior: silent
    on success, error on the first miss)."""
    if path_exists(path=dir_path):
        for f in files:
            fpath = os.path.join(dir_path, f)
            if not path_exists(path=fpath):
                raise ValueError(f"File {fpath} doesn't exist in the "
                                 "given fileset")
