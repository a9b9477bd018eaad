"""Checkpoint / resume of the branch-and-bound state (port of
``omc/utils/checkpoint.py``).

The reference has no checkpointing: on timeout the tree is lost.  The whole
solver state that matters is small host data (the frontier of ``BBNode``s
with their boxes and cuts, the incumbent, the node census, the run log and
the RNG state), so ``matrix_completion_branchandbound(checkpoint_path=...)``
pickles it periodically and ``resume=True`` continues from it.  The device
holds no state between super-steps (warm-start states are an optimisation,
rebuilt lazily).

A checkpoint holds this package's own ``omc_torch.tree.BBTree`` /
``BBNode`` objects: it is not meant to load checkpoints written by ``omc``,
nor ``omc`` to load these.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Any, Dict

CHECKPOINT_VERSION = 1


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Atomically write a checkpoint (write a temporary file, then rename)."""
    payload = dict(payload)
    payload["__version__"] = CHECKPOINT_VERSION
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        payload = pickle.load(f)
    version = payload.pop("__version__", None)
    if version != CHECKPOINT_VERSION:
        raise ValueError(
            f"checkpoint version mismatch: file has {version}, "
            f"code expects {CHECKPOINT_VERSION}"
        )
    return payload


__all__ = ["save_checkpoint", "load_checkpoint", "CHECKPOINT_VERSION"]
