"""Folder-of-audio dataset for transcription of user files.

Equivalent of the reference `Custom` dataset (reference
utils/custom_dataset.py:7-90): glob `<audio_path>/*.<ext>`, mono-mix,
resample to 16 kHz, pad/crop to `max_segment_samples`, and return the
waveform (the sampling entry pairs it with Gaussian noise, reference
sampling.py:27-43)."""

from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np

from ..io.wav import read_wav, resample


class Custom:
    def __init__(
        self,
        audio_path: str,
        audio_ext: str = "wav",
        max_segment_samples: int = 327680,
        sample_rate: int = 16000,
    ):
        folder = pathlib.Path(audio_path)
        self.files = sorted(folder.glob(f"*.{audio_ext}"))
        if not self.files:
            raise FileNotFoundError(f"no *.{audio_ext} files under {folder}")
        self.sample_rate = sample_rate
        self.segment_samples = max_segment_samples

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Dict[str, object]:
        x, sr = read_wav(self.files[idx], mono=True)
        if sr != self.sample_rate:
            x = resample(x, sr, self.sample_rate)
        if len(x) >= self.segment_samples:
            x = x[: self.segment_samples]
        else:
            x = np.pad(x, (0, self.segment_samples - len(x)))
        return {"audio": x.astype(np.float32), "file_name": self.files[idx].name}


class DoubleDataset:
    """Zip two datasets; batches become (item1, item2) pairs — the
    dual-loss finetuning recipe (reference continue_train_both.py:17-25)."""

    def __init__(self, ds1, ds2):
        self.ds1, self.ds2 = ds1, ds2

    def __len__(self) -> int:
        return min(len(self.ds1), len(self.ds2))

    def __getitem__(self, idx: int):
        return self.ds1[idx], self.ds2[idx]

    def getitem_at(self, idx: int, epoch=None):
        """Forward the DataLoader's explicit epoch so both children keep
        deterministic window draws (see amt.PairedAudioMidi.getitem_at)."""
        def fetch(ds):
            if hasattr(ds, "getitem_at"):
                return ds.getitem_at(idx, epoch)
            return ds[idx]

        return fetch(self.ds1), fetch(self.ds2)
