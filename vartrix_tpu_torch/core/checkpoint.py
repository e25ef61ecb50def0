"""Per-variant score spill / resume.

The reference writes outputs once at the end and has no resume story
(SURVEY.md §5.4). For long multi-hour runs over large cohorts this module
spills each variant's per-read score block as it is computed; a rerun
with the same inputs and filter configuration skips straight past the
already-scored variants. Only the alignment phase (the expensive part)
is checkpointed — aggregation and output writing are cheap and rerun.

Validity is keyed on a manifest hash of the input file identities
(path, size, mtime) and every behavior-affecting flag; a mismatched
manifest invalidates the directory.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger("vartrix")


def manifest_key(paths: list, flags: dict) -> str:
    h = hashlib.sha256()
    for p in paths:
        st = os.stat(p)
        h.update(f"{p}|{st.st_size}|{st.st_mtime_ns}".encode())
    h.update(json.dumps(flags, sort_keys=True).encode())
    return h.hexdigest()[:32]


class ScoreCheckpoint:
    def __init__(self, directory: str, key: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        mpath = os.path.join(directory, "MANIFEST")
        if os.path.exists(mpath):
            existing = open(mpath).read().strip()
            if existing != key:
                log.error(
                    "Checkpoint directory %s was created for different "
                    "inputs/flags; ignoring its contents", directory)
                for f in os.listdir(directory):
                    if f.endswith(".npy"):
                        os.unlink(os.path.join(directory, f))
        with open(mpath, "wt") as f:
            f.write(key)

    def _path(self, row: int) -> str:
        return os.path.join(self.dir, f"scores_{row}.npy")

    def load(self, row: int) -> Optional[np.ndarray]:
        p = self._path(row)
        if not os.path.exists(p):
            return None
        try:
            return np.load(p)
        except Exception:
            return None

    def save(self, row: int, scores: np.ndarray) -> None:
        # np.save appends .npy when missing, so keep the suffix on the tmp
        tmp = os.path.join(self.dir, f"scores_{row}.tmp.npy")
        np.save(tmp, scores)
        os.replace(tmp, self._path(row))
