"""Video files through the port's native FFmpeg library (port of
``data/decoder.py``; reference: slowfast/datasets/decoder.py:150-354).

``csrc/decode.cpp`` (the port's own copy) is compiled with ``g++`` against
FFmpeg (``pkg-config`` libavformat, libavcodec, libswscale, libavutil) at
first use, never at import, into ``build/torch_decode/libesf_decode.so``
under the repository root, and rebuilt when the source is newer or the
library lacks a symbol that this module binds. Where ``pkg-config`` or
``g++`` is missing, or the build fails, the first call raises with the
command's output: there is no other decoder.

The library does the reference's selective decode: a seek to the clip
window's start with a 1024-pts margin, the clip window (clip_size =
sampling_rate · num_frames / target_fps · fps, random or uniformly placed),
linspace sampling to num_frames, and a bilinear swscale resize of the short
side into a right-padded canvas buffer. A random window takes one uniform
draw from the caller's ``np.random.Generator``.
"""

from __future__ import annotations

import _ctypes
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from ..utils.logging import get_logger

logger = get_logger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "decode.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_decode")
_PKG_CONFIG = ["libavformat", "libavcodec", "libswscale", "libavutil"]

#: union-decode return codes that say the media cannot take the union
#: (ambiguous pts -14/-15, views too far apart to overlap -16); any other
#: failure may be transient and says nothing about the media
UNION_UNSUPPORTED_CODES = (-14, -15, -16)

_c = ctypes
_P = _c.POINTER
#: every entry point this module binds: (restype, argtypes)
_SIGNATURES = {
    "esf_decode_clip2": (_c.c_int, [
        _c.c_char_p, _c.c_int, _c.c_double, _c.c_double, _c.c_int, _c.c_int,
        _c.c_double, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _P(_c.c_ubyte), _P(_c.c_int), _P(_c.c_int)]),
    "esf_decode_views": (_c.c_int, [
        _c.c_char_p, _c.c_int, _c.c_double, _c.c_double, _c.c_int, _c.c_int,
        _c.c_int, _c.c_int, _c.c_int, _P(_c.c_ubyte), _P(_c.c_int),
        _P(_c.c_int)]),
    "esf_stream_open": (_c.c_void_p, [
        _c.c_char_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int,
        _P(_c.c_double), _P(_c.c_int64), _P(_c.c_int64), _P(_c.c_int),
        _P(_c.c_int), _P(_c.c_int)]),
    "esf_stream_next": (_c.c_int, [
        _c.c_void_p, _P(_c.c_ubyte), _P(_c.c_longlong)]),
    "esf_stream_close": (None, [_c.c_void_p]),
    "esf_probe": (_c.c_int, [
        _c.c_char_p, _P(_c.c_double), _P(_c.c_int64), _P(_c.c_int),
        _P(_c.c_int)]),
    "esf_encoder_open2": (_c.c_void_p, [
        _c.c_char_p, _c.c_int, _c.c_int, _c.c_int, _c.c_int]),
    "esf_encoder_append": (_c.c_int, [
        _c.c_void_p, _P(_c.c_ubyte), _c.c_int]),
    "esf_encoder_close": (_c.c_int, [_c.c_void_p]),
}

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


class UnionUnsupported(Exception):
    """``decode_views`` declined the media for good (a code of
    ``UNION_UNSUPPORTED_CODES``): per-view decodes serve it."""

    def __init__(self, path: str, rc: int):
        super().__init__(f"union decode declined {path!r} ({rc})")
        self.rc = rc


def lib_path() -> str:
    return os.path.join(BUILD_DIR, "libesf_decode.so")


def _run(cmd) -> str:
    """``cmd``'s standard output; raises with its output where it is
    missing or fails."""
    if shutil.which(cmd[0]) is None:
        raise RuntimeError(
            f"cannot build the video decoder: {cmd[0]!r} is not installed "
            "(it needs g++, pkg-config and the FFmpeg development libraries)")
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return proc.stdout


def build(dest: Optional[str] = None) -> str:
    """Compile ``csrc/decode.cpp`` into ``dest`` (``lib_path()``): to a
    temporary file that is renamed into place, so that a process loading
    the library never sees half of one."""
    dest = dest or lib_path()
    cflags = _run(["pkg-config", "--cflags", *_PKG_CONFIG]).split()
    libs = _run(["pkg-config", "--libs", *_PKG_CONFIG]).split()
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(dest))
    os.close(fd)
    try:
        _run(["g++", "-O2", "-fPIC", "-std=c++17", "-Wall", *cflags,
              "-shared", SOURCE, "-o", tmp, *libs])
        os.replace(tmp, dest)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.info("built the video decoder %s", dest)
    return dest


def _stale(path: str) -> bool:
    return (not os.path.exists(path)
            or os.path.getmtime(SOURCE) > os.path.getmtime(path))


def missing_symbols(lib: ctypes.CDLL):
    """The entry points of ``_SIGNATURES`` that ``lib`` lacks."""
    return [name for name in _SIGNATURES if not hasattr(lib, name)]


def open_library(path: str) -> ctypes.CDLL:
    """The library at ``path`` with every entry point bound: built where
    it is missing or older than the source, and rebuilt where it does not
    load or lacks an entry point."""
    if _stale(path):
        build(path)
    try:
        lib = ctypes.CDLL(path)
        missing = missing_symbols(lib)
    except OSError as e:
        lib, missing = None, [f"a loadable library ({e})"]
    if missing:
        logger.warning("the video decoder %s lacks %s; rebuilding", path,
                       ", ".join(missing))
        if lib is not None:  # else dlopen would hand back the old library
            _ctypes.dlclose(lib._handle)
        build(path)
        lib = ctypes.CDLL(path)
        missing = missing_symbols(lib)
        if missing:
            raise RuntimeError(f"{path} lacks {missing} after a rebuild")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The decode library, built and loaded once per process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = open_library(lib_path())
        return _LIB


def _buffer_width(short_side: int, max_aspect: float,
                  width_hint: Optional[int]) -> int:
    """The decode buffer's long axis: ``max_aspect`` times the short side
    (at least 2:1), or the exact extent a previous decode of the same path
    at this short side gave (``width_hint``)."""
    max_w = max(short_side * 2, int(round(short_side * max_aspect)))
    if width_hint is not None:
        max_w = min(max_w, max(int(width_hint), 1))
    return max_w


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def decode_clip(path: str, num_frames: int, sampling_rate: float,
                clip_idx: int, num_clips: int, target_fps: float,
                short_side: int, random_clip: bool,
                multi_thread: bool = False, max_aspect: float = 2.0,
                width_hint: Optional[int] = None,
                rng: Optional[np.random.Generator] = None
                ) -> Optional[np.ndarray]:
    """One clip in its natural orientation, short side ``short_side``:
    uint8 (num_frames, short_side, W, 3) for landscape media, (num_frames,
    H, short_side, 3) for portrait (the library writes tall content
    transposed into the landscape buffer; the swap back is a view), the
    long axis at most ``max_aspect`` times the short side (content beyond
    it centre-cropped). ``width_hint``: the exact long-axis extent this
    path gave at this short side before, to size the buffer; a too-small
    hint would crop content. A random window (``random_clip``) takes one
    ``rng.random()`` draw. Returns None where the decode failed (the caller
    retries, reference kinetics.py:192-255).
    """
    lib = get_lib()
    max_w = _buffer_width(short_side, max_aspect, width_hint)
    # the library writes every row and zeroes the right-pad tail itself
    out = np.empty((num_frames, short_side, max_w, 3), np.uint8)
    out_w, out_portrait = ctypes.c_int(0), ctypes.c_int(0)
    rnd = 0.0
    if random_clip:
        if rng is None:
            raise ValueError("decode_clip: a random window needs rng")
        rnd = rng.random()
    rc = lib.esf_decode_clip2(
        path.encode(), num_frames, float(sampling_rate), float(target_fps),
        -1 if random_clip else int(clip_idx), int(num_clips), float(rnd),
        int(short_side), int(max_w), int(bool(multi_thread)), 1, _u8(out),
        ctypes.byref(out_w), ctypes.byref(out_portrait))
    if rc != 0:
        logger.warning("native decode failed (%d) for %s", rc, path)
        return None
    frames = out[:, :, : out_w.value]
    if out_portrait.value:
        frames = np.swapaxes(frames, 1, 2)
    return frames


def decode_views(path: str, num_frames: int, sampling_rate: float,
                 num_clips: int, target_fps: float, short_side: int,
                 multi_thread: bool = False, max_aspect: float = 2.0,
                 width_hint: Optional[int] = None) -> Optional[np.ndarray]:
    """All ``num_clips`` temporal test views of one video from about two
    sequential decodes: uint8 (num_clips, num_frames, H, W, 3), equal to
    ``num_clips`` ``decode_clip`` calls with clip_idx 0..num_clips-1. Raises
    ``UnionUnsupported`` where the media cannot take the union (ambiguous
    pts, or views too sparse to overlap: per-view seeks are faster there);
    returns None on any other failure."""
    lib = get_lib()
    max_w = _buffer_width(short_side, max_aspect, width_hint)
    out = np.empty((num_clips, num_frames, short_side, max_w, 3), np.uint8)
    out_w, out_portrait = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.esf_decode_views(
        path.encode(), num_frames, float(sampling_rate), float(target_fps),
        int(num_clips), int(short_side), int(max_w), int(bool(multi_thread)),
        1, _u8(out), ctypes.byref(out_w), ctypes.byref(out_portrait))
    if rc in UNION_UNSUPPORTED_CODES:
        raise UnionUnsupported(path, rc)
    if rc != 0:
        logger.warning("native union decode failed (%d) for %s", rc, path)
        return None
    frames = out[:, :, :, : out_w.value]
    if out_portrait.value:
        frames = np.swapaxes(frames, 2, 3)
    return frames


class VideoStream:
    """Every frame of a video file in order, each decoded once: iterate
    ``(pts, frame)``, ``frame`` uint8 in its natural orientation
    (landscape ``(short, W, 3)``, portrait ``(H, short, 3)``), byte for
    byte the same frame of a ``decode_clip`` result. ``fps``,
    ``nb_frames`` and ``duration`` are the container's (0 where it lacks
    them). Iteration stops at the end of the stream and raises
    ``RuntimeError`` where a packet fails to read or decode mid-stream.
    A context manager, or ``close()``."""

    def __init__(self, path: str, short_side: int, multi_thread: bool = False,
                 max_aspect: float = 2.0, width_hint: Optional[int] = None):
        self._lib = get_lib()
        self._h = None
        self.path = path
        self._short = int(short_side)
        self._max_w = _buffer_width(short_side, max_aspect, width_hint)
        fps, nb, dur = ctypes.c_double(0), ctypes.c_int64(0), ctypes.c_int64(0)
        out_w, out_p, err = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        self._h = self._lib.esf_stream_open(
            path.encode(), int(bool(multi_thread)), self._short, self._max_w,
            1, ctypes.byref(fps), ctypes.byref(nb), ctypes.byref(dur),
            ctypes.byref(out_w), ctypes.byref(out_p), ctypes.byref(err))
        if not self._h:
            raise RuntimeError(f"esf_stream_open({path!r}) failed: {err.value}")
        self.fps = fps.value
        self.nb_frames = int(nb.value)
        self.duration = int(dur.value)
        self.width = int(out_w.value)
        self.portrait = bool(out_p.value)

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        buf = np.empty((self._short, self._max_w, 3), np.uint8)
        pts = ctypes.c_longlong(0)
        rc = self._lib.esf_stream_next(self._h, _u8(buf), ctypes.byref(pts))
        if rc != 0:
            self.close()
            if rc < 0:
                raise RuntimeError(
                    f"decoding {self.path!r} failed mid-stream ({rc})")
            raise StopIteration
        frame = buf[:, : self.width]
        if self.portrait:
            frame = np.swapaxes(frame, 0, 1)
        return int(pts.value), frame

    def close(self):
        if self._h is not None:
            self._lib.esf_stream_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def probe(path: str):
    """{"fps", "nb_frames", "width", "height"} of the video stream, or None
    where the file does not open."""
    lib = get_lib()
    fps, nb = ctypes.c_double(0), ctypes.c_int64(0)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.esf_probe(path.encode(), ctypes.byref(fps), ctypes.byref(nb),
                       ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return {"fps": fps.value, "nb_frames": nb.value,
            "width": w.value, "height": h.value}


class VideoEncoder:
    """An mp4 (mpeg4) written a window at a time: ``append`` (N, H, W, 3)
    uint8 RGB frames, ``close`` writes the trailer, in constant memory over
    any length (the reference streams through cv2.VideoWriter,
    tools/demo_net.py:62-75). ``gop``: the keyframe interval (8 keeps test
    seeks cheap; x264 defaults to 250). A context manager."""

    def __init__(self, path: str, width: int, height: int, fps: int,
                 gop: int = 8):
        self._lib = get_lib()
        self._h = self._lib.esf_encoder_open2(
            path.encode(), int(width), int(height), max(int(fps), 1),
            int(gop))
        if not self._h:
            raise RuntimeError(f"cannot open encoder for {path}")
        self.path = path
        self.width, self.height = int(width), int(height)
        self.frames_written = 0

    def append(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(
                f"expected (N, H, W, 3) RGB frames, got {frames.shape}")
        if frames.dtype != np.uint8:
            raise ValueError(f"expected uint8 frames, got {frames.dtype}")
        n, h, w, _ = frames.shape
        if (h, w) != (self.height, self.width):
            raise ValueError(f"window size {(h, w)} != encoder size "
                             f"{(self.height, self.width)}")
        frames = np.ascontiguousarray(frames)
        rc = self._lib.esf_encoder_append(self._h, _u8(frames), n)
        if rc != 0:
            raise RuntimeError(f"encoder append failed ({rc}) writing "
                               f"{self.path}")
        self.frames_written += n

    def close(self) -> None:
        if self._h:
            rc = self._lib.esf_encoder_close(self._h)
            self._h = None
            if rc != 0:
                raise RuntimeError(f"encoder close failed ({rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_test_video(path: str, frames: np.ndarray, fps: int = 30,
                     gop: int = 8) -> None:
    """Encode uint8 (N, H, W, 3) frames to an mpeg4 file (test fixtures)."""
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    with VideoEncoder(path, w, h, fps, gop=gop) as enc:
        enc.append(frames)
