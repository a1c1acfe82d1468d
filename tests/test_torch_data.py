"""The port's own copies of the host-side data path (`data/`, `io/`,
`eval/notes`, `native`) against the JAX package's, on one synthetic tree
written here: the same files give exactly the same items, batches, rolls
and notes. Also `to_device`, the port's own step from a numpy batch to
tensors. Both packages' native tiers are held to C++ where `g++` is present
(`torch_native_tiers`)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from diffroll_tpu import data as jdata
from diffroll_tpu import native as jnative
from diffroll_tpu.eval import notes as jnotes
from diffroll_tpu.io import midi as jmidi
from diffroll_tpu.io import wav as jwav
from diffroll_tpu_torch import data as tdata
from diffroll_tpu_torch import native as tnative
from diffroll_tpu_torch.eval import notes as tnotes
from diffroll_tpu_torch.io import midi as tmidi
from diffroll_tpu_torch.io import wav as twav
from torch_native_tiers import native_tiers_pinned  # noqa: F401

SR, HOP = 16000, 512
NOTES = [(60, 0.5, 1.0), (64, 1.0, 2.0), (67, 2.5, 3.0), (43, 0.1, 3.7)]


def _clip(path: pathlib.Path, seed: int, seconds=4.0, sr=SR, label="mid"):
    rng = np.random.RandomState(seed)
    jwav.write_wav(path.with_suffix(".wav"), rng.randn(int(seconds * sr)).astype(np.float32) * 0.1,
                   sr)
    if label == "mid":
        jmidi.write_midi(str(path.with_suffix(".mid")), [p for p, _, _ in NOTES],
                         [(a, b) for _, a, b in NOTES])
    else:
        rows = ["OnsetTime\tOffsetTime\tMidiPitch"]
        rows += [f"{a:.3f}\t{b:.3f}\t{p}" for p, a, b in NOTES]
        path.with_suffix(".txt").write_text("\n".join(rows) + "\n")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    seed = 0
    for subset in ("AkPnBcht", "SptkBGAm", "ENSTDkAm"):
        d = root / "MAPS" / subset / "MUS"
        d.mkdir(parents=True)
        for i in range(3):
            seed += 1
            # MAPS ships .txt labels beside the MIDI; cover both readers
            _clip(d / f"clip{i}", seed, seconds=3.0 + i, label="txt" if i == 2 else "mid")
    d = root / "maestro-v3.0.0" / "2020"
    d.mkdir(parents=True)
    rows = {"split": {}, "audio_filename": {}, "midi_filename": {}}
    for i, split in enumerate(["train", "train", "validation", "test"]):
        _clip(d / f"p{i}", 100 + i, sr=44100 if i == 0 else SR)  # one file to resample
        rows["split"][str(i)] = split
        rows["audio_filename"][str(i)] = f"2020/p{i}.wav"
        rows["midi_filename"][str(i)] = f"2020/p{i}.mid"
    (root / "maestro-v3.0.0" / "maestro-v3.0.0.json").write_text(json.dumps(rows))
    folder = root / "my_audio"
    folder.mkdir()
    for i in range(2):
        _clip(folder / f"song{i}", 200 + i, seconds=1.0 + i)
    return root


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


DATASETS = {
    "maps_train": lambda m, r: m.MAPS(str(r), groups="train", sequence_length=SR * 2),
    "maps_test": lambda m, r: m.MAPS(str(r), groups="test", sequence_length=SR * 2),
    "maps_whole": lambda m, r: m.MAPS(str(r), groups="test", sequence_length=None),
    "maps_preload": lambda m, r: m.MAPS(str(r), groups="train", sequence_length=SR, preload=True,
                                        seed=7),
    "maestro_train": lambda m, r: m.MAESTRO(str(r), groups="train", sequence_length=SR * 2),
    "maestro_val": lambda m, r: m.MAESTRO(str(r), groups="validation", sequence_length=SR),
    "custom": lambda m, r: m.Custom(str(r / "my_audio"), "wav", max_segment_samples=SR * 3 // 2),
    "double": lambda m, r: m.DoubleDataset(
        m.MAPS(str(r), groups="train", sequence_length=SR),
        m.MAESTRO(str(r), groups="train", sequence_length=SR)),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match(tree, name):
    j, t = DATASETS[name](jdata, tree), DATASETS[name](tdata, tree)
    assert len(j) == len(t) > 0
    for i in range(len(j)):
        _assert_same(t[i], j[i])
        if hasattr(j, "getitem_at"):
            for epoch in (0, 3):
                _assert_same(t.getitem_at(i, epoch), j.getitem_at(i, epoch))


@pytest.mark.parametrize("name,kw", [
    ("maps_train", dict(batch_size=2, shuffle=True, drop_last=True, seed=3, num_workers=2)),
    ("maps_test", dict(batch_size=4, shuffle=False, drop_last=False, num_workers=1)),
    ("double", dict(batch_size=2, shuffle=True, drop_last=True, seed=1, num_workers=3,
                    prefetch=1)),
    ("custom", dict(batch_size=2)),
], ids=["train", "eval", "double", "custom"])
def test_loader_batches_match(tree, name, kw):
    j = jdata.DataLoader(DATASETS[name](jdata, tree), **kw)
    t = tdata.DataLoader(DATASETS[name](tdata, tree), **kw)
    assert len(j) == len(t) > 0
    for _ in range(2):  # two epochs: the shuffles and the window draws move on together
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) == len(j)
        for a, b in zip(tb, jb):
            _assert_same(a, b)


def test_maps_download_raises(tree):
    with pytest.raises(RuntimeError):
        tdata.MAPS(str(tree), download=True)


def test_rasterize_and_notes_match():
    notes = [jmidi.MidiNote(a, b, p, 100) for p, a, b in NOTES]
    tnotes_in = [tmidi.MidiNote(a, b, p, 100) for p, a, b in NOTES]
    jf, jo = jdata.rasterize_notes(notes, 130, HOP, SR)
    tf, to = tdata.rasterize_notes(tnotes_in, 130, HOP, SR)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(to, jo)
    jb, tb = jdata.roll_to_notes(jf, HOP, SR), tdata.roll_to_notes(tf, HOP, SR)
    assert [(n.onset, n.offset, n.pitch) for n in tb] == [(n.onset, n.offset, n.pitch) for n in jb]
    rng = np.random.default_rng(0)
    roll = (rng.random((200, 88)) > 0.7).astype(np.float32) * rng.random((200, 88)).astype(
        np.float32)
    # the roll is both the onsets and the frames, as the pipeline decodes it
    got = tnotes.extract_notes(roll, roll, 0.5, 0.5)
    assert len(got[0]) > 0
    for a, b in zip(got, jnotes.extract_notes(roll, roll, 0.5, 0.5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tnotes.extract_notes_reference_loop(roll, roll, 0.5, 0.5),
                    jnotes.extract_notes_reference_loop(roll, roll, 0.5, 0.5)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got, tnotes.extract_notes_reference_loop(roll, roll, 0.5, 0.5)):
        np.testing.assert_array_equal(a, b)


def test_io_copies_read_the_same(tree):
    wav = tree / "maestro-v3.0.0" / "2020" / "p0.wav"
    (jx, jsr), (tx, tsr) = jwav.read_wav(wav), twav.read_wav(wav)
    assert jsr == tsr == 44100
    np.testing.assert_array_equal(tx, jx)
    assert twav.wav_info(wav) == jwav.wav_info(wav)
    np.testing.assert_array_equal(twav.resample(tx, 44100, SR), jwav.resample(jx, 44100, SR))
    mid = wav.with_suffix(".mid")
    assert [tuple(vars(n).values()) for n in tmidi.read_midi(str(mid))] == \
        [tuple(vars(n).values()) for n in jmidi.read_midi(str(mid))]
    out = tree / "copy.mid"
    tmidi.write_midi(str(out), [p for p, _, _ in NOTES], [(a, b) for _, a, b in NOTES])
    assert out.read_bytes() == mid.read_bytes()
    twav.write_wav(tree / "copy_t.wav", tx, tsr)
    jwav.write_wav(tree / "copy_j.wav", jx, jsr)
    assert (tree / "copy_t.wav").read_bytes() == (tree / "copy_j.wav").read_bytes()


def test_native_copy_matches():
    """The port builds its own library from its own source; both tiers (C++
    where a compiler is present, numpy otherwise) give the JAX package's
    results."""
    assert tnative.available() == jnative.available()
    rng = np.random.default_rng(1)
    x = rng.standard_normal(44100).astype(np.float32)
    np.testing.assert_array_equal(tnative.resample(x, 44100, SR), jnative.resample(x, 44100, SR))
    roll = rng.random((120, 88)) > 0.6
    got, want = tnative.extract_notes(roll, roll), jnative.extract_notes(roll, roll)
    assert (got is None) == (want is None) == (not tnative.available())
    assert got is None or len(got[0]) > 0
    for a, b in zip(got or (), want or ()):
        np.testing.assert_array_equal(a, b)
    if tnative.available():
        src = pathlib.Path(tnative.__file__).parent
        assert (src / "src" / "native.cpp").exists()
        assert any((src / "_build").glob("*.so"))


def test_collate_matches():
    items = [({"a": np.ones(3, np.float32) * i, "n": f"f{i}"}, {"b": np.zeros(2) + i})
             for i in range(3)]
    _assert_same(tdata.collate(items), jdata.collate(items))


def test_to_device_keeps_values_and_names(tree):
    ds = DATASETS["custom"](tdata, tree)
    batch = next(iter(tdata.DataLoader(ds, 2)))
    out = tdata.to_device(batch, "cpu")
    assert isinstance(out["audio"], torch.Tensor) and out["audio"].dtype == torch.float32
    np.testing.assert_array_equal(out["audio"].numpy(), batch["audio"])
    assert list(out["file_name"]) == list(batch["file_name"]) == ["song0.wav", "song1.wav"]
    pair = tdata.to_device((batch, batch), torch.device("cpu"))
    assert isinstance(pair, tuple) and torch.equal(pair[1]["audio"], out["audio"])
