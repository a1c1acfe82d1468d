"""Automatic-music-transcription datasets: MAPS, MAESTRO, and the generic
paired (audio, MIDI) folder dataset they share.

Replacement for the external `AudioLoader.music.amt.{MAPS,
MAESTRO}` package the reference depends on (reference requirements.txt:9;
ctor contract enumerated in config/dataset/MAPS.yaml / MAESTRO.yaml:
root, groups, sequence_length, seed, hop_length, min/max_midi, ext_audio,
sampling_rate, overlap/data_type). Batch contract preserved exactly:
`__getitem__` -> {'frame': (frames, 88) float32, 'audio': (sequence_length,)
float32} (consumption: reference task/diffusion.py:652-665).

Design notes (host-side, pure numpy):
  * audio is decoded once and memo-cached as float32 @ target rate
    (`preload=True` eagerly, lazily otherwise);
  * labels come from the paired MIDI (or MAPS .txt) file, rasterized on
    the fly for the sampled window only;
  * train mode samples a random `sequence_length` window per fetch,
    hashed statelessly from (seed, clip, epoch) — the DataLoader passes
    the epoch via `getitem_at`, so windows reproduce across worker
    counts, thread interleavings and concurrent iterators (reference
    datasets pass seed=42; plain `ds[i]` falls back to a per-clip
    draw counter);
    eval mode (`sequence_length=None` or `deterministic=True`) yields the
    clip head, matching the reference's fixed eval segments.

Downloading a corpus is not supported: `download=True` raises with
instructions instead of fetching.
"""

from __future__ import annotations

import csv
import json
import pathlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.midi import MidiNote, read_midi
from ..io.wav import read_wav, resample, resampled_length, wav_info
from .rasterize import rasterize_arrays


def _read_maps_txt(path: pathlib.Path) -> List[MidiNote]:
    """MAPS ships tab-separated `OnsetTime OffsetTime MidiPitch` label files."""
    notes = []
    with open(path) as f:
        reader = csv.reader(f, delimiter="\t")
        header = next(reader, None)
        for row in reader:
            if len(row) < 3:
                continue
            notes.append(
                MidiNote(onset=float(row[0]), offset=float(row[1]),
                         pitch=int(float(row[2])), velocity=100)
            )
    return notes


class PairedAudioMidi:
    """A folder of (audio, label) pairs + windowed sampling."""

    def __init__(
        self,
        pairs: Sequence[Tuple[pathlib.Path, pathlib.Path]],
        sequence_length: Optional[int] = 327680,
        seed: int = 42,
        hop_length: int = 512,
        min_midi: int = 21,
        max_midi: int = 108,
        sampling_rate: int = 16000,
        preload: bool = False,
        deterministic: bool = False,
        extend_sustain: bool = True,
        overlap: bool = False,
        eval_overlap_frames: int = 0,
        max_cache_bytes: Optional[int] = 8 << 30,
    ):
        if not pairs:
            raise FileNotFoundError("dataset resolved to zero (audio, label) pairs")
        self.pairs = list(pairs)
        self.sequence_length = sequence_length
        self.hop_length = hop_length
        self.min_midi = min_midi
        self.max_midi = max_midi
        self.sampling_rate = sampling_rate
        self.deterministic = deterministic
        self.extend_sustain = extend_sustain
        # eval segmentation (the reference's `overlap: True` eval knob,
        # reference config/dataset/MAPS.yaml:26-44): the dataset enumerates
        # consecutive sequence_length windows COVERING every recording, so
        # eval scores full clips, not just each clip's head. Window items
        # carry clip_idx / start_frame / n_clip_frames so the eval loop can
        # reassemble per-recording rolls.
        self.overlap = bool(overlap) and sequence_length is not None
        # context-overlapped eval windows: consecutive windows share
        # `eval_overlap_frames` frames, so no scored frame sits closer than
        # overlap/2 to a window edge (except recording edges); the eval
        # loop crossfade-stitches them (tasks/transcribe.stitch_rolls).
        # 0 = butted tiles.
        self.eval_overlap_frames = int(eval_overlap_frames)
        self._windows: Optional[List[Tuple[int, int]]] = None
        self._lengths: Dict[int, int] = {}
        self._seed = int(seed)
        self._draw_counts: Dict[int, int] = {}
        self._draw_lock = threading.Lock()
        # decoded-audio memo-cache, LRU-bounded: MAESTRO-scale corpora
        # (~200 h -> ~46 GB of f32 @ 16 kHz) cannot be held whole in host
        # RAM; least-recently-used clips are evicted past max_cache_bytes
        # (None = unbounded). Notes are tiny and stay unbounded.
        self.max_cache_bytes = max_cache_bytes
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()
        self._audio_cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._notes_cache: Dict[int, List[MidiNote]] = {}
        # per-clip (onsets, offsets, pitches) arrays — the rasterizer hot
        # path takes these with a scalar window offset, so per-window work
        # involves no per-note Python objects
        self._note_arrays_cache: Dict[int, Tuple[np.ndarray, ...]] = {}
        if preload:
            for i in range(len(self.pairs)):
                self._audio(i)
                self._notes(i)

    def __len__(self) -> int:
        if self.overlap:
            return len(self._window_index())
        return len(self.pairs)

    def _length(self, idx: int) -> int:
        """Clip length in samples at the target rate, from the WAV header
        (no decode) unless the clip is already cached."""
        if idx not in self._lengths:
            if idx in self._audio_cache:
                self._lengths[idx] = len(self._audio_cache[idx])
            else:
                n, sr = wav_info(self.pairs[idx][0])
                self._lengths[idx] = resampled_length(n, sr, self.sampling_rate)
        return self._lengths[idx]

    def _window_index(self) -> List[Tuple[int, int]]:
        if self._windows is None:
            # stride by whole FRAMES (a window labels seq//hop frames), so
            # consecutive windows tile the frame grid exactly even when
            # sequence_length is not a hop multiple; with
            # eval_overlap_frames the stride shrinks so windows share
            # context at the seams
            win_frames = max(self.sequence_length // self.hop_length, 1)
            ov = min(max(self.eval_overlap_frames, 0), win_frames - 1)
            stride_frames = win_frames - ov
            stride = stride_frames * self.hop_length
            wins: List[Tuple[int, int]] = []
            for i in range(len(self.pairs)):
                total_frames = max(1, -(-self._length(i) // self.hop_length))
                n_win = self.n_windows(total_frames)
                for w in range(n_win):
                    wins.append((i, w * stride))
            self._windows = wins
        return self._windows

    def n_windows(self, total_frames: int) -> int:
        """Eval windows covering a `total_frames`-frame recording under the
        current (win, overlap) geometry — the eval loop uses this to know
        when a recording's windows are complete."""
        win_frames = max(self.sequence_length // self.hop_length, 1)
        ov = min(max(self.eval_overlap_frames, 0), win_frames - 1)
        return 1 + max(0, -(-(total_frames - win_frames) // (win_frames - ov)))

    def _hash_draw(self, clip_idx: int, k: int) -> int:
        """Stateless random integer for window starts: splitmix64 over the
        packed (seed, clip, draw-index) key — fully deterministic given k."""
        clip_idx = int(clip_idx)  # numpy ints overflow the 64-bit mixing
        z = (self._seed * 0x9E3779B97F4A7C15
             + clip_idx * 0xBF58476D1CE4E5B9 + int(k)) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return int((z ^ (z >> 31)) & 0x7FFFFFFF)

    def _draw(self, clip_idx: int) -> int:
        """Draw index from a per-clip counter — the fallback for plain
        `ds[i]` access. Within one loader epoch each clip is fetched once,
        so the counter equals the epoch ordinal; but when the SAME dataset
        object feeds two concurrent iterators, which fetch gets which count
        is thread-scheduling dependent. The DataLoader therefore passes the
        epoch explicitly via `getitem_at` and never takes this path."""
        clip_idx = int(clip_idx)
        with self._draw_lock:
            k = self._draw_counts.get(clip_idx, 0)
            self._draw_counts[clip_idx] = k + 1
        return self._hash_draw(clip_idx, k)

    def _audio(self, idx: int) -> np.ndarray:
        with self._cache_lock:
            if idx in self._audio_cache:
                self._audio_cache.move_to_end(idx)
                return self._audio_cache[idx]
        wav_path, _ = self.pairs[idx]
        x, sr = read_wav(wav_path, mono=True)
        if sr != self.sampling_rate:
            x = resample(x, sr, self.sampling_rate)
        x = x.astype(np.float32)
        with self._cache_lock:
            if idx not in self._audio_cache:
                self._audio_cache[idx] = x
                self._cache_bytes += x.nbytes
                if self.max_cache_bytes is not None:
                    while (self._cache_bytes > self.max_cache_bytes
                           and len(self._audio_cache) > 1):
                        _, old = self._audio_cache.popitem(last=False)
                        self._cache_bytes -= old.nbytes
        return x

    def _notes(self, idx: int) -> List[MidiNote]:
        if idx not in self._notes_cache:
            _, label_path = self.pairs[idx]
            if label_path.suffix.lower() == ".txt":
                notes = _read_maps_txt(label_path)
            else:
                notes = read_midi(str(label_path), extend_sustain=self.extend_sustain)
            self._notes_cache[idx] = notes
        return self._notes_cache[idx]

    def _note_arrays(self, idx: int) -> Tuple[np.ndarray, ...]:
        if idx not in self._note_arrays_cache:
            notes = self._notes(idx)
            self._note_arrays_cache[idx] = (
                np.array([n.onset for n in notes], np.float64),
                np.array([n.offset for n in notes], np.float64),
                np.array([n.pitch for n in notes], np.int64),
            )
        return self._note_arrays_cache[idx]

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.getitem_at(idx, None)

    def getitem_at(self, idx: int,
                   epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Fetch item `idx` with an explicit draw context: when `epoch` is
        given, the random train window is hashed statelessly from
        (seed, clip, epoch) — reproducible across worker counts, thread
        interleavings, AND concurrent iterators over the same dataset
        object (the DataLoader protocol). `epoch=None` falls back to the
        per-clip counter (plain `ds[i]` access)."""
        if self.overlap:
            clip_idx, start = self._window_index()[idx]
            return self._window(clip_idx, start, with_meta=True)
        return self._window(idx, None, epoch=epoch)

    def _window(self, clip_idx: int, start: Optional[int],
                with_meta: bool = False,
                epoch: Optional[int] = None) -> Dict[str, np.ndarray]:
        """One sequence_length window of clip `clip_idx`. `start=None`
        picks it (random hop-aligned in train, 0 when deterministic)."""
        audio = self._audio(clip_idx)
        onsets, offsets, pitches = self._note_arrays(clip_idx)
        seq = self.sequence_length
        if seq is None:
            seq = max(len(audio) // self.hop_length, 1) * self.hop_length

        if start is None:
            if self.deterministic or len(audio) <= seq:
                start = 0
            else:
                # align segment starts to the hop grid so roll frames line up
                max_start = (len(audio) - seq) // self.hop_length
                draw = (self._hash_draw(clip_idx, epoch) if epoch is not None
                        else self._draw(clip_idx))
                start = (draw % (max_start + 1)) * self.hop_length
        audio_seg = audio[start : start + seq]
        if len(audio_seg) < seq:
            audio_seg = np.pad(audio_seg, (0, seq - len(audio_seg)))

        n_frames = seq // self.hop_length
        frame, onset = rasterize_arrays(
            onsets, offsets, pitches,
            n_frames, self.hop_length, self.sampling_rate,
            self.min_midi, self.max_midi,
            frame_offset=start // self.hop_length,
        )
        item = {"frame": frame, "audio": audio_seg, "onset": onset}
        if with_meta:
            item["clip_idx"] = np.int32(clip_idx)
            item["start_frame"] = np.int32(start // self.hop_length)
            item["n_clip_frames"] = np.int32(
                max(1, -(-len(audio) // self.hop_length)))
        return item


def _find_label(audio: pathlib.Path) -> Optional[pathlib.Path]:
    for suffix in (".mid", ".midi", ".MID", ".txt"):
        cand = audio.with_suffix(suffix)
        if cand.exists():
            return cand
    return None


# MAPS instrument subsets: synthesized ones train, the Disklavier recordings
# (ENSTDk*) test — the split used by the paper's MAPS protocol.
_MAPS_TRAIN_SUBSETS = (
    "AkPnBcht", "AkPnBsdf", "AkPnCGdD", "AkPnStgb",
    "SptkBGAm", "SptkBGCl", "StbgTGd2",
)
_MAPS_TEST_SUBSETS = ("ENSTDkAm", "ENSTDkCl")


class MAPS(PairedAudioMidi):
    """MAPS piano dataset (MUS subset) with the train/test instrument split."""

    def __init__(
        self,
        root: str,
        groups: str = "train",
        data_type: str = "MUS",
        download: bool = False,
        overlap: Optional[bool] = None,
        **kw,
    ):
        if download:
            raise RuntimeError(
                "downloading is not supported; place MAPS under "
                f"{root}/MAPS/<subset>/{data_type}/ manually"
            )
        if overlap is None:
            # reference defaults: random windows in train, full-coverage
            # eval segmentation otherwise (config/dataset/MAPS.yaml:15,29,44)
            overlap = groups != "train"
        kw["overlap"] = overlap
        base = pathlib.Path(root)
        maps_root = base / "MAPS" if (base / "MAPS").exists() else base
        subsets = _MAPS_TRAIN_SUBSETS if groups == "train" else _MAPS_TEST_SUBSETS
        pairs = []
        for subset in subsets:
            d = maps_root / subset / data_type
            if not d.exists():
                continue
            for wav in sorted(d.glob("*.wav")):
                label = _find_label(wav)
                if label is not None:
                    pairs.append((wav, label))
        kw.setdefault("deterministic", groups != "train")
        # MAPS .txt labels already encode sustain; MIDI labels follow the
        # same convention as MAESTRO
        super().__init__(pairs, **kw)


class MAESTRO(PairedAudioMidi):
    """MAESTRO v2/v3 with the official split from the metadata json/csv."""

    def __init__(
        self,
        root: str,
        groups: str = "train",
        download: bool = False,
        overlap: Optional[bool] = None,
        **kw,
    ):
        if download:
            raise RuntimeError(
                "downloading is not supported; place MAESTRO under "
                f"{root}/maestro-v*/ manually"
            )
        kw["overlap"] = groups != "train" if overlap is None else overlap
        base = pathlib.Path(root)
        candidates = sorted(base.glob("maestro-v*")) or [base]
        droot = candidates[-1]
        pairs = self._pairs_from_metadata(droot, groups)
        if pairs is None:  # no metadata: treat as a flat folder of pairs
            pairs = []
            for wav in sorted(droot.rglob("*.wav")):
                label = _find_label(wav)
                if label is not None:
                    pairs.append((wav, label))
        kw.setdefault("deterministic", groups != "train")
        super().__init__(pairs, **kw)

    @staticmethod
    def _pairs_from_metadata(droot: pathlib.Path, groups: str):
        meta_json = sorted(droot.glob("maestro-v*.json"))
        meta_csv = sorted(droot.glob("maestro-v*.csv"))
        entries = None
        if meta_json:
            raw = json.loads(meta_json[0].read_text())
            if isinstance(raw, list):  # v2 layout: list of row dicts
                entries = raw
            else:  # v3 layout: dict of column -> {index: value}
                keys = list(raw["split"].keys())
                entries = [
                    {col: raw[col][k] for col in raw} for k in keys
                ]
        elif meta_csv:
            with open(meta_csv[0]) as f:
                entries = list(csv.DictReader(f))
        if entries is None:
            return None
        pairs = []
        for e in entries:
            if e["split"] != groups:
                continue
            wav = droot / e["audio_filename"]
            midi = droot / e["midi_filename"]
            if wav.exists() and midi.exists():
                pairs.append((wav, midi))
        return pairs
