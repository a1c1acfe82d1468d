"""The port's native host library (`diffroll_tpu_torch.native`): its
first-use build under processes that start together, the note decoder's
`frames` argument, and the C++ tier against the numpy tier.

No jax here: the spawned workers import this module."""

import ctypes
import multiprocessing as mp
import shutil

import numpy as np
import pytest

from diffroll_tpu_torch import native
from diffroll_tpu_torch.eval import notes

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler on this host")
N_PROCS = 8


def _point_at(build) -> None:
    native._BUILD = build
    native._LIB_PATH = build / "libdiffroll_native.so"
    native._FPR_PATH = build / "fingerprint.txt"
    native._lib, native._tried = None, False


def _patch_build(monkeypatch, build) -> None:
    """`_point_at` for this process, undone after the test."""
    for name, value in (("_BUILD", build), ("_LIB_PATH", build / "libdiffroll_native.so"),
                        ("_FPR_PATH", build / "fingerprint.txt"), ("_lib", None),
                        ("_tried", False)):
        monkeypatch.setattr(native, name, value)


def _first_use(build, barrier, results) -> None:
    """One process's first use of the library in `build`, released with the
    others by `barrier`."""
    _point_at(build)
    barrier.wait(timeout=30)
    try:
        tier = "c++" if native._load() is not None else "numpy"
        results.put((tier, native._FPR_PATH.read_text().strip()))
    except Exception as err:  # reported to the parent, which fails the test
        results.put(("error", repr(err)))


@needs_gxx
def test_concurrent_first_use_builds_once(tmp_path):
    """Eight processes load the library from one empty directory at once:
    every one takes the C++ tier with the same fingerprint, and the
    directory holds one library and no temporary file. (The loader without
    its lock and its `os.replace` lost about one load in ten this way.)"""
    ctx = mp.get_context("spawn")
    for trial in range(2):
        build = tmp_path / f"build{trial}"
        barrier, results = ctx.Barrier(N_PROCS), ctx.Queue()
        procs = [ctx.Process(target=_first_use, args=(build, barrier, results))
                 for _ in range(N_PROCS)]
        for p in procs:
            p.start()
        got = [results.get(timeout=60) for _ in procs]
        for p in procs:
            p.join(timeout=30)
            assert not p.is_alive() and p.exitcode == 0
        assert [tier for tier, _ in got] == ["c++"] * N_PROCS, got
        assert len({fpr for _, fpr in got}) == 1
        files = sorted(p.name for p in build.iterdir())
        assert files == [".lock", "fingerprint.txt", "libdiffroll_native.so"], files


@needs_gxx
def test_a_valid_cache_loads_where_the_lock_cannot_be_taken(tmp_path, monkeypatch):
    """A checkout built once by another user: `_build/` holds a valid library
    but its lock cannot be opened (here `.lock` is a directory, which refuses
    even root). The cache loads without the lock; once the fingerprint no
    longer matches, the loader cannot build and takes the numpy tier, without
    raising."""
    build = tmp_path / "_build"
    _patch_build(monkeypatch, build)
    assert native._load() is not None
    (build / ".lock").unlink()
    (build / ".lock").mkdir()
    build.chmod(0o555)
    try:
        _patch_build(monkeypatch, build)
        assert native.available()
        _patch_build(monkeypatch, build)
        monkeypatch.setattr(native, "_fingerprint", lambda: "another toolchain")
        assert not native.available()
        assert sorted(p.name for p in build.iterdir()) == [
            ".lock", "fingerprint.txt", "libdiffroll_native.so"]
    finally:
        build.chmod(0o755)


@needs_gxx
def test_a_built_library_that_does_not_load_raises(tmp_path, monkeypatch):
    """A library the loader built but cannot `dlopen` raises with the
    loader's message; it does not fall back to numpy."""
    _patch_build(monkeypatch, tmp_path / "_build")

    def refuse(path, *a, **k):
        raise OSError(f"{path}: invalid ELF header")

    monkeypatch.setattr(ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="cannot be loaded: .*invalid ELF header"):
        native._load()
    assert (tmp_path / "_build" / "libdiffroll_native.so").stat().st_size > 100


def test_no_compiler_takes_the_numpy_tier(monkeypatch):
    monkeypatch.setattr(native, "_fingerprint", lambda: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    assert native.extract_notes(np.ones((4, 3), bool), True) is None


def _numpy_tier(monkeypatch) -> None:
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def _roll(seed=0, shape=(200, 88)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) > 0.7).astype(np.float32) * rng.random(shape).astype(np.float32)


@needs_gxx
@pytest.mark.parametrize("frames", ["scalar_false", "scalar_true", "row", "column"])
def test_extract_notes_broadcasts_frames(frames, monkeypatch):
    """A `frames` of another shape than the onsets' is broadcast to it, as the
    numpy tier broadcasts it, and the scan reads nothing past it: the result
    is the numpy tier's and the same on every call."""
    roll = _roll(1) > 0.5
    fr = {"scalar_false": np.bool_(False), "scalar_true": np.bool_(True),
          "row": np.arange(88) % 3 > 0, "column": np.arange(200)[:, None] % 5 > 0}[frames]
    got = [native.extract_notes(roll, fr) for _ in range(3)]
    _numpy_tier(monkeypatch)
    want = notes.extract_notes(roll, fr, 0.5, 0.5)
    for g in got:
        for a, b in zip(g, want):
            np.testing.assert_array_equal(a, b)
    assert (len(want[0]) == 0) == (frames == "scalar_false")


@needs_gxx
@pytest.mark.parametrize("shape", [(200, 89), (199, 88), (2, 88), (200, 88, 1)])
def test_extract_notes_refuses_frames_that_do_not_broadcast(shape):
    roll = _roll(2) > 0.5
    with pytest.raises(ValueError):
        native.extract_notes(roll, np.ones(shape, bool))
    with pytest.raises(ValueError, match="onsets must be a"):
        native.extract_notes(roll[None], roll[None])


@pytest.mark.parametrize("rule", ["rule1", "rule2"])
def test_native_tier_matches_the_numpy_tier(rule, monkeypatch):
    """One seeded roll through `eval.notes.extract_notes` on the C++ tier
    (where a compiler is present) and on the numpy tier: the same notes, and
    the reference loop's."""
    roll = _roll(3)
    got = notes.extract_notes(roll, roll, 0.5, 0.5, rule=rule)
    _numpy_tier(monkeypatch)
    want = notes.extract_notes(roll, roll, 0.5, 0.5, rule=rule)
    assert len(want[0]) > 100
    for a, b, c in zip(got, want, notes.extract_notes_reference_loop(roll, roll, rule=rule)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_numpy_tier_decodes_a_key_held_through_the_window(monkeypatch):
    """A key active in every frame has no inactive frame to end on: its note
    runs to T, as in the reference loop (the numpy tier's offset search once
    indexed an empty array here)."""
    roll = np.zeros((50, 88), np.float32)
    roll[:, 40] = 1.0
    roll[10:20, 7] = 1.0
    _numpy_tier(monkeypatch)
    got = notes.extract_notes(roll, roll)
    want = notes.extract_notes_reference_loop(roll, roll)
    np.testing.assert_array_equal(got[0], [40, 7])
    np.testing.assert_array_equal(got[1], [[0, 50], [10, 20]])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
