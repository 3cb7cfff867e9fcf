"""Container probe (port of ``data/video_container.py``; reference:
slowfast/datasets/video_container.py:7-29).

The reference returns a PyAV container; the port decodes with one native
call (data/decoder.py), so ``get_video_container`` returns the probe's
dict, for code that checks that a video opens."""

from __future__ import annotations

from . import decoder


def get_video_container(path_to_vid: str, multi_thread_decode: bool = False,
                        backend: str = "ffmpeg"):
    assert backend in ("ffmpeg", "pyav", "torchvision"), backend
    info = decoder.probe(path_to_vid)
    if info is None:
        raise RuntimeError(f"Failed to open video {path_to_vid}")
    return info
