"""Per-SNR checkpoint/resume for long Monte-Carlo sweeps (port of
esn_ofdm_mimo_tpu/utils/checkpoint.py, the same pickle layout: one
`snr_XXX.pkl` per completed SNR point under the checkpoint directory).

Each completed SNR point's accumulated result is saved, so an interrupted
sweep resumes at the first SNR point it has not finished.
"""
from __future__ import annotations

import os
import pickle
from typing import Any


class SnrCheckpoint:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _file(self, snr_idx: int) -> str:
        return os.path.join(self.path, f"snr_{snr_idx:03d}.pkl")

    def has(self, snr_idx: int) -> bool:
        return os.path.exists(self._file(snr_idx))

    def save(self, snr_idx: int, obj: Any) -> None:
        tmp = self._file(snr_idx) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(obj, f)
        os.replace(tmp, self._file(snr_idx))

    def load(self, snr_idx: int) -> Any:
        # the files are this program's own, written by `save`
        with open(self._file(snr_idx), "rb") as f:
            return pickle.load(f)

    def load_or_none(self, snr_idx: int) -> Any:
        """Load a checkpoint, or None if it is unreadable or stale.

        Counter NamedTuples pickle positionally, so a checkpoint written by
        a revision with other fields raises on unpickle; a resumed run then
        simulates that SNR point again rather than crash. Only stale-shape
        and truncated-file errors are swallowed: an I/O error on a good
        checkpoint propagates instead of silently re-simulating an
        expensive SNR point."""
        try:
            return self.load(snr_idx)
        except (TypeError, KeyError, AttributeError, EOFError,
                pickle.UnpicklingError, ModuleNotFoundError) as e:
            print(f"[ckpt] snr {snr_idx}: stale/unreadable checkpoint "
                  f"({type(e).__name__}: {e}); re-simulating")
            return None
