"""The staleness rule of ``_build``, on the CPU without nvcc: a library
is rebuilt when it is missing or older than its source or any header
``csrc/*.cuh``."""

import os

import pytest

from efficient_slowfast_tpu_torch.ops.kernels import _build


@pytest.mark.parametrize("newest,stale", [
    ("none", True),   # no library yet
    ("so", False),    # the library is newer than every input
    ("cu", True),     # its source was edited
    ("cuh", True),    # a header it may include was edited
    ("other_cu", False),  # another kernel's source was edited
])
def test_stale_when_missing_or_older_than_source_or_header(
        tmp_path, monkeypatch, newest, stale):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    files = {"cu": csrc / "k.cu", "cuh": csrc / "helpers.cuh",
             "other_cu": csrc / "other.cu", "so": build / "libk.so"}
    for path in files.values():
        path.write_text("")
    if newest == "none":
        files["so"].unlink()
    for i, (key, path) in enumerate(sorted(files.items())):
        if path.exists():
            os.utime(path, (1000 + i, 1000 + i))
    if newest != "none":
        os.utime(files[newest], (5000, 5000))
    assert _build._stale("k") is stale
