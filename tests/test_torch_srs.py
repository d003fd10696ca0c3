"""The reference's native engine and SRS as the port's tests use them.

The reference's loader (jolt_atlas_tpu/curve/native.py ``_load``) rebuilds
csrc/libmsm.so in place whenever csrc/msm.cpp is newer, in every process,
with no lock and no rename. A test worker that opens the library while
another worker's linker is writing it keeps no library for the rest of its
life: the reference then falls back to pure Python, ``KZGSRS.setup`` gives
no raw points and ``prepared_bases()`` gives None. A fresh checkout writes
the library before the source, so the first run after it rebuilds.

``reference_native`` waits out such a rebuild and loads the library again;
every port test module that builds a reference SRS calls it before its
fixtures do. ``port_srs`` and ``port_pp`` build the port's SRS and
preprocessing from the reference's through its serialisation, never
through its private fields. The cases below hold the helper against a
simulated lost race, a rebuild that finishes while it waits, and a library
that never loads.
"""

import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from jolt_atlas_tpu.commitment.kzg import KZGSRS as RefSRS
from jolt_atlas_tpu.curve import native as ref_native
from jolt_atlas_tpu_torch import convert
from jolt_atlas_tpu_torch.commitment.kzg import KZGSRS
from jolt_atlas_tpu_torch.preprocessing import AtlasPreprocessing

WAIT_S = 180.0  # a rebuild takes seconds alone, far longer beside a busy suite
POLL_S = 0.25


def _opens(so: str) -> tuple:
    """(whether ``so`` opens, why not), tried in a child process: a
    half-written library can map past its end, and opening it then kills
    the process with SIGBUS."""
    r = subprocess.run([sys.executable, "-c",
                        "import ctypes, sys; ctypes.CDLL(sys.argv[1])", so],
                       capture_output=True, text=True, timeout=60)
    lines = r.stderr.strip().splitlines()
    return r.returncode == 0, lines[-1] if lines else f"exit {r.returncode}"


def _stamp(path: str) -> tuple:
    st = os.stat(path)
    return st.st_ino, st.st_size, st.st_mtime_ns


def reference_native(wait_s: float = WAIT_S):
    """The reference's csrc library, loaded in this process: when its
    loader gave up (a lost rebuild race), wait until libmsm.so is no older
    than msm.cpp and opens, then let the loader load it again. Fails the
    calling test, naming the library, if that takes longer than
    ``wait_s``. Never rebuilds the library itself."""
    if ref_native.available():
        return ref_native._LIB
    csrc = os.path.join(ref_native._repo_root(), "csrc")
    so, src = os.path.join(csrc, "libmsm.so"), os.path.join(csrc, "msm.cpp")
    deadline = time.monotonic() + wait_s
    while True:
        try:
            stamp = _stamp(so)
            if os.path.getmtime(so) < os.path.getmtime(src):
                why = "it is older than msm.cpp"
            else:
                ok, why = _opens(so)
                if ok and _stamp(so) == stamp:
                    # whole and newer than its source: the loader opens it
                    # without a rebuild
                    ref_native._TRIED, ref_native._LIB = False, None
                    if ref_native.available():
                        return ref_native._LIB
                    why = "the reference's loader rejected it"
        except OSError as e:
            why = str(e)
        if time.monotonic() >= deadline:
            pytest.fail(f"the reference's native library {so} did not load "
                        f"within {wait_s:.0f} s: {why}")
        time.sleep(POLL_S)


def _g2(p):
    return (p.x.a, p.x.b, p.y.a, p.y.b)


def port_srs(ref_srs) -> KZGSRS:
    """The port's KZG SRS holding the reference SRS's points, through the
    reference's own serialisation."""
    return KZGSRS.deserialize(ref_srs.serialize())


def port_pp(ref_model, ref_pp) -> AtlasPreprocessing:
    """The port's preprocessing of ``ref_model`` (its describe_model
    loaded by the port) on the reference preprocessing's SRS."""
    model = convert.model_from_reference(convert.describe_model(ref_model))
    return AtlasPreprocessing(model, port_srs(ref_pp.srs))


# ---------------------------------------------------------------------------
# the helper against a lost race
# ---------------------------------------------------------------------------

N = 64


def test_helper_restores_a_lost_race(monkeypatch):
    """The loader's state after a lost race (_LIB None, _TRIED True): the
    reference falls back to Python points; the helper loads the library
    again, KZGSRS.setup gives raw points, and the port's SRS through the
    helper equals the one from the raw points taken before the race."""
    reference_native()
    before = RefSRS.setup(N - 1)
    limbs = np.frombuffer(before._raw_points, dtype=np.uint64).reshape(-1, 8)
    want = convert.srs_from_arrays(limbs, _g2(before.g2), _g2(before.beta_g2),
                                   [_g2(p) for p in before.g2_powers])
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    lost = RefSRS.setup(N - 1)
    assert lost._raw_points is None and lost.prepared_bases() is None
    assert reference_native() is not None
    assert ref_native.available()
    after = RefSRS.setup(N - 1)
    assert after._raw_points == before._raw_points
    assert after.prepared_bases() is not None
    for ref in (before, after, lost):
        assert port_srs(ref).serialize() == want.serialize()


def _csrc_copy(root, so_bytes, so_age, monkeypatch):
    """A checkout at ``root`` holding csrc/msm.cpp and, unless
    ``so_bytes`` is None, a libmsm.so of those bytes ``so_age`` seconds
    older than the source (negative: newer); the reference's loader
    pointed at it, its state that of a lost race."""
    real = os.path.join(ref_native._repo_root(), "csrc")
    csrc = root / "csrc"
    csrc.mkdir()
    shutil.copyfile(os.path.join(real, "msm.cpp"), csrc / "msm.cpp")
    t = time.time() - 3600
    os.utime(csrc / "msm.cpp", (t, t))
    if so_bytes is not None:
        (csrc / "libmsm.so").write_bytes(so_bytes)
        os.utime(csrc / "libmsm.so", (t - so_age, t - so_age))
    monkeypatch.setattr(ref_native, "_repo_root", lambda: str(root))
    monkeypatch.setattr(ref_native, "_LIB", None)
    monkeypatch.setattr(ref_native, "_TRIED", True)
    return csrc


def _real_so() -> bytes:
    reference_native()
    with open(os.path.join(ref_native._repo_root(), "csrc", "libmsm.so"),
              "rb") as f:
        return f.read()


def test_helper_waits_for_the_rebuild(monkeypatch, tmp_path):
    """A half-written library, newer than its source, as another worker's
    linker leaves it mid-write: the helper waits until the link finishes
    (the whole library renamed into place 1 s later), then loads it."""
    whole = _real_so()
    csrc = _csrc_copy(tmp_path, whole[:4096], -60, monkeypatch)

    def finish():
        time.sleep(1.0)
        (csrc / "libmsm.tmp").write_bytes(whole)
        os.replace(csrc / "libmsm.tmp", csrc / "libmsm.so")

    linker = threading.Thread(target=finish)
    linker.start()
    t0 = time.monotonic()
    try:
        lib = reference_native(wait_s=60)
    finally:
        linker.join()
    assert lib is not None and time.monotonic() - t0 >= 1.0
    assert ref_native.available()


@pytest.mark.parametrize("state", ["missing", "older_than_source",
                                   "half_written"])
def test_helper_fails_naming_the_library(monkeypatch, tmp_path, state):
    """A library that never loads fails the test once the wait is over,
    with a message naming the library, and is never rebuilt by the
    helper: a stale one stays as it was."""
    so_bytes, age = {"missing": (None, 0),
                     "older_than_source": (_real_so(), 60),
                     "half_written": (_real_so()[:4096], -60)}[state]
    csrc = _csrc_copy(tmp_path, so_bytes, age, monkeypatch)
    with pytest.raises(pytest.fail.Exception,
                       match=re.escape(str(csrc / "libmsm.so"))):
        reference_native(wait_s=0.5)
    if so_bytes is None:
        assert not (csrc / "libmsm.so").exists()
    else:
        assert (csrc / "libmsm.so").read_bytes() == so_bytes
