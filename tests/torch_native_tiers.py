"""A module-scoped autouse fixture for the port's tests that compare a
native-backed result (resampling, rasterising, note decoding) with the JAX
package's.

The JAX package's loader compiles straight onto its shared `_build/` path
with no lock, so test workers that reach first use together can `dlopen` a
half-written file and quietly take the numpy tier, whose resampling differs
in the last bits. The fixture points the JAX copy at a build directory of
this worker's own (the pattern of `tests/test_native.py`, editing no JAX
file), and, where `g++` is present, requires both packages to load the C++
tier, so that a test can never compare C++ with numpy without saying so.

Import it into a test module: `from torch_native_tiers import
native_tiers_pinned  # noqa: F401`."""

import shutil

import pytest


@pytest.fixture(scope="module", autouse=True)
def native_tiers_pinned(tmp_path_factory):
    import diffroll_tpu.native as jnative
    import diffroll_tpu_torch.native as tnative

    build = tmp_path_factory.getbasetemp() / "jax_native_build"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_BUILD", build)
        mp.setattr(jnative, "_LIB_PATH", build / "libdiffroll_native.so")
        mp.setattr(jnative, "_FPR_PATH", build / "fingerprint.txt")
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        if shutil.which("g++"):
            assert jnative.available(), "the JAX copy fell back to numpy on a host with g++"
            assert tnative.available(), "the port fell back to numpy on a host with g++"
        yield
