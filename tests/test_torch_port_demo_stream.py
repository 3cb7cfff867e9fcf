"""The demo's window sources and overlays (``engine/demo.py``) against the
JAX package's, function against function, on the CPU: the file stream
against the per-window seek path byte for byte on landscape, portrait and
gop-250 media; the stream's repair of a mid-stream decode error; the camera
stream's buffering and subsampling; and the overlays byte for byte. The
config is ``configs/Synthetic/SHUFFLENETV2_TINY.yaml`` (8 frames, sampling
rate 2, the 32-pixel test crop, TARGET_FPS 30)."""

import logging

import numpy as np
import pytest

from efficient_slowfast_tpu.config import get_cfg as jax_get_cfg
from efficient_slowfast_tpu.data import decoder as jax_decoder
from efficient_slowfast_tpu.engine import demo as jax_demo
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data import decoder
from efficient_slowfast_tpu_torch.engine import demo

TINY = "configs/Synthetic/SHUFFLENETV2_TINY.yaml"


def tiny_cfg(get, source=""):
    cfg = get()
    cfg.merge_from_file(TINY)
    cfg.DEMO.DATA_SOURCE = source
    return cfg


def num_windows(cfg):
    info = decoder.probe(cfg.DEMO.DATA_SOURCE)
    clip_s = (cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
              / cfg.DATA.TARGET_FPS)
    return max(int(info["nb_frames"] / info["fps"] / clip_s), 1)


def assert_same_windows(got, want, what):
    assert [w for w, _ in got] == [w for w, _ in want], what
    for (w, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype == np.uint8, (what, w)
        assert a.shape == b.shape, (what, w)
        assert np.array_equal(a, b), (what, w)


def differs(got, want):
    return [w for w, _ in got] != [w for w, _ in want] or any(
        a.shape != b.shape or not np.array_equal(a, b)
        for (_, a), (_, b) in zip(got, want))


@pytest.mark.parametrize("name,h,w,gop", [("land", 96, 128, 8),
                                          ("tall", 128, 72, 8),
                                          ("gop250", 96, 128, 250)])
def test_file_stream_is_jax_seek_path(tmp_path, name, h, w, gop):
    """The port's sequential stream gives JAX's per-window seek windows byte
    for byte (and its own seek path's), as tests/test_demo.py holds JAX's
    stream against its seeks."""
    src = str(tmp_path / f"{name}.mp4")
    decoder.write_test_video(src, np.random.RandomState(3).randint(
        0, 255, (96, h, w, 3), np.uint8), fps=24, gop=gop)
    cfg, jcfg = tiny_cfg(get_cfg, src), tiny_cfg(jax_get_cfg, src)
    n = num_windows(cfg)
    streamed = list(demo.file_window_stream(cfg))
    want = list(jax_demo._seek_window_stream(jcfg, n))
    assert len(want) >= 2
    assert_same_windows(streamed, want, name)
    assert_same_windows(list(demo._seek_window_stream(cfg, n)), want, name)
    assert_same_windows(list(jax_demo.file_window_stream(jcfg)), want, name)


def damaged_video(tmp_path, frames=96, after=40):
    """(an mp4 of ``frames`` seeded frames at 30 fps, six windows of the
    tiny config, whose first P frame from the ``after``-th on has forward
    f_code 0, which the mpeg4 decoder rejects as damaged: the recipe of
    tests/test_torch_port_decode.py::_broken_stream; that frame's index)."""
    path = str(tmp_path / "src.mp4")
    decoder.write_test_video(path, np.random.RandomState(0).randint(
        0, 255, (frames, 48, 64, 3), np.uint8), fps=30)
    data = bytearray(open(path, "rb").read())
    vops = [i for i in range(len(data) - 4)
            if data[i:i + 4] == b"\x00\x00\x01\xb6"]
    k = next(i for i in range(after, len(vops))
             if data[vops[i] + 4] >> 6 == 1)  # vop_coding_type P
    start = vops[k] + 4
    bits = np.unpackbits(np.frombuffer(bytes(data[start:start + 8]),
                                       np.uint8))
    pos = 2
    while bits[pos]:  # modulo_time_base
        pos += 1
    pos += 1 + 1 + 5 + 1 + 1 + 1 + 3 + 5
    bits[pos:pos + 3] = 0  # vop_fcode_forward
    data[start:start + 8] = np.packbits(bits).tobytes()
    bad = str(tmp_path / "bad.mp4")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    return bad, k


def test_a_mid_stream_decode_error_replays_through_seeks(tmp_path, caplog):
    """On the damaged file the port's stream raises at the damaged frame
    (tests/test_torch_port_decode.py), and the port's window stream replays
    the rest through seeks from the first unfinished window: its windows
    are JAX's seek path's byte for byte. JAX's stream skips the damaged
    frame as JAX's seeks do, so there JAX's windows are its seeks' too."""
    bad, k = damaged_video(tmp_path)
    cfg, jcfg = tiny_cfg(get_cfg, bad), tiny_cfg(jax_get_cfg, bad)
    n = num_windows(cfg)
    assert n >= 3
    with pytest.raises(RuntimeError, match="mid-stream"):
        for _ in decoder.VideoStream(bad, cfg.DATA.TEST_CROP_SIZE):
            pass
    want = list(jax_demo._seek_window_stream(jcfg, n))
    with caplog.at_level(logging.WARNING):
        got = list(demo.file_window_stream(cfg))
    replayed = [r.getMessage() for r in caplog.records
                if "falling back" in r.getMessage()]
    # windows of 16 frames every 13 1/3: frame 40 is the first one that
    # window 2 (frames 27-41) has not seen; windows 0 and 1 came streamed
    assert k == 40 and len(replayed) == 1
    assert replayed[0].endswith("from window 2"), replayed
    assert_same_windows(got, want, "port stream, damaged file")
    assert_same_windows(list(jax_demo.file_window_stream(jcfg)), want,
                        "JAX stream, damaged file")


def ends_at(stream_cls, k, fail):
    """``stream_cls`` yielding its first ``k`` frames and then failing as
    each package's library fails a read error there: JAX's
    (csrc/decode.cpp:665-671) reports the end of the stream, the port's
    raises RuntimeError."""

    class Stream(stream_cls):
        seen = 0

        def __next__(self):
            if self.seen == k:
                self.close()
                fail()
            self.seen += 1
            return super().__next__()

    return Stream


def test_a_read_error_makes_jax_windows_partial_and_the_port_replays(
        tmp_path, monkeypatch):
    """Where the library fails a read mid-stream, JAX's stream ends there
    and finishes its open windows from partial frames, so its windows are
    not its seek path's; the port's stream raises there, and its windows
    are JAX's seek path's byte for byte."""
    src = str(tmp_path / "clip.mp4")
    decoder.write_test_video(src, np.random.RandomState(5).randint(
        0, 255, (96, 48, 64, 3), np.uint8), fps=30)
    cfg, jcfg = tiny_cfg(get_cfg, src), tiny_cfg(jax_get_cfg, src)
    n = num_windows(cfg)
    want = list(jax_demo._seek_window_stream(jcfg, n))
    assert len(want) == n >= 3

    def eof():
        raise StopIteration

    def error():
        raise RuntimeError("decoding failed mid-stream (-5)")

    monkeypatch.setattr(jax_demo.decoder, "VideoStream",
                        ends_at(jax_decoder.VideoStream, 40, eof))
    monkeypatch.setattr(demo.decoder, "VideoStream",
                        ends_at(decoder.VideoStream, 40, error))
    theirs = list(jax_demo.file_window_stream(jcfg))
    assert differs(theirs, want)
    assert [w for w, _ in theirs] == [0, 1, 2]  # window 2 from 8 frames
    assert_same_windows(list(demo.file_window_stream(cfg)), want,
                        "port stream, read error")


class _FakeCapture:
    """cv2.VideoCapture stand-in: serves BGR frames, tracks release()."""

    def __init__(self, frames_bgr):
        self._frames = list(frames_bgr)
        self._pos = 0
        self.released = False

    def read(self):
        if self._pos >= len(self._frames):
            return False, None
        f = self._frames[self._pos]
        self._pos += 1
        return True, f

    def release(self):
        self.released = True


def test_camera_stream_buffers_and_subsamples_as_jax():
    """NUM_FRAMES × SAMPLING_RATE frames buffered a window, every
    SAMPLING_RATE-th kept, BGR to RGB, the remainder dropped, the capture
    released: JAX's windows byte for byte."""
    frames = []
    for i in range(21):
        f = np.random.RandomState(i).randint(0, 255, (48, 64, 3), np.uint8)
        f[..., 0] = i  # BGR blue: the frame index
        frames.append(f)
    got, want = [], []
    for get, module, out in ((get_cfg, demo, got),
                             (jax_get_cfg, jax_demo, want)):
        cfg = get()
        cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE = 4, 2
        cap = _FakeCapture(frames)
        out.extend(module.camera_window_stream(cfg, capture=cap))
        assert cap.released
    assert_same_windows(got, want, "camera")
    assert [w for w, _ in got] == [0, 1]
    for widx, clip in got:
        assert clip.shape == (4, 48, 64, 3)
        assert [int(clip[i, 0, 0, 2]) for i in range(4)] == \
            [8 * widx + 2 * i for i in range(4)]


def test_overlays_are_jax_overlays_byte_for_byte():
    rs = np.random.RandomState(7)
    frames = rs.randint(0, 255, (3, 40, 72, 3), np.uint8)
    for entry in ({"top_classes": ["class3", "class1"], "scores": [0.5123, 0.25],
                   "fps": 12.3},
                  {"top_classes": [7, 2, 9], "scores": [0.9, 0.05, 0.0001],
                   "fps": 1234.5}):
        got = demo._annotate(frames, entry)
        assert np.array_equal(got, jax_demo._annotate(frames, entry))
        assert not np.array_equal(got, frames)
    entry = {"boxes": [{"box": [3.0, 4.5, 30.2, 38.0], "top_classes": ["run"],
                        "scores": [0.75]},
                       {"box": [40.0, 0.0, 71.0, 12.0], "top_classes": [4],
                        "scores": [0.01]}]}
    got = demo._annotate_boxes(frames, entry)
    assert np.array_equal(got, jax_demo._annotate_boxes(frames, entry))
    assert not np.array_equal(got, frames)
