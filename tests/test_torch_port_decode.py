"""The port's video decoder (its own copy of the native library, built at
first use into build/torch_decode/) against the JAX package's, on fixture
videos written here (GOP 8): a landscape, a portrait and a wider than 2:1
clip. Clips through the seek path (test views, a random window given the
same draw), the union decode of every view, the stream, the probe and the
encoder must be byte for byte JAX's. Also the three decode faults of the
JAX package that the port repairs: a library lacking an entry point that
the wrapper binds is rebuilt, and a stream that fails mid-way raises."""

import _ctypes
import ctypes
import os
import subprocess

import numpy as np
import pytest

from efficient_slowfast_tpu.data import decoder as jax_decoder
from efficient_slowfast_tpu_torch.data import decoder, video_container

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (frames, height, width)
SHAPES = {"land": (40, 45, 80), "tall": (40, 96, 36), "wide": (40, 30, 90)}
SHORT = 24


class Draw:
    """One ``random()`` draw, for the port's generator argument."""

    def __init__(self, value):
        self.value = value

    def random(self):
        return self.value


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    out = {}
    for i, (name, (n, h, w)) in enumerate(SHAPES.items()):
        rs = np.random.RandomState(i)
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([y * 255 // h, x * 255 // w, (x + y) % 256], -1)
        frames = np.clip(base[None] + 4 * np.arange(n)[:, None, None, None]
                         + rs.randint(-20, 20, (n, h, w, 3)), 0, 255)
        out[name] = str(root / f"{name}.mp4")
        decoder.write_test_video(out[name], frames.astype(np.uint8), fps=30,
                                 gop=8)
    return out


def _equal(a, b):
    assert a is not None and b is not None
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


def test_library_is_the_ports_own(videos):
    lib = decoder.get_lib()
    assert os.path.dirname(lib._name) == os.path.join(ROOT, "build",
                                                      "torch_decode")
    assert not decoder.missing_symbols(lib)


@pytest.mark.parametrize("name", list(SHAPES))
def test_probe_and_container_match_jax(videos, name):
    info = decoder.probe(videos[name])
    assert info == jax_decoder.probe(videos[name])
    n, h, w = SHAPES[name]
    assert (info["nb_frames"], info["height"], info["width"]) == (n, h, w)
    assert video_container.get_video_container(videos[name]) == info
    assert decoder.probe(videos[name] + ".missing") is None


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("aspect", [2.0, 4.0])
def test_seek_views_match_jax(videos, name, aspect):
    """Each of 5 test views, and a second pass with the width hint."""
    for view in range(5):
        args = (videos[name], 4, 2, view, 5, 30, SHORT, False)
        got = decoder.decode_clip(*args, max_aspect=aspect)
        _equal(got, jax_decoder.decode_clip(*args, max_aspect=aspect))
        hint = max(got.shape[1], got.shape[2])
        _equal(decoder.decode_clip(*args, max_aspect=aspect,
                                   width_hint=hint), got)
    if name == "tall":  # natural orientation: the short side is the width
        assert got.shape[2] == SHORT and got.shape[1] > SHORT
    if name == "wide":  # 3:1 kept to the cap
        assert got.shape[2] == (72 if aspect == 4.0 else 48)


@pytest.mark.parametrize("name", list(SHAPES))
def test_random_window_matches_jax_given_the_draw(videos, name, monkeypatch):
    for u in (0.0, 0.37, 0.99):
        got = decoder.decode_clip(videos[name], 4, 2, -1, 1, 30, SHORT, True,
                                  max_aspect=4.0, rng=Draw(u))
        monkeypatch.setattr(jax_decoder.random, "random", lambda: u)
        _equal(got, jax_decoder.decode_clip(videos[name], 4, 2, -1, 1, 30,
                                            SHORT, True, max_aspect=4.0))
    with pytest.raises(ValueError, match="rng"):
        decoder.decode_clip(videos[name], 4, 2, -1, 1, 30, SHORT, True)


@pytest.mark.parametrize("name", list(SHAPES))
def test_union_views_match_jax(videos, name):
    args = (videos[name], 4, 2, 10, 30, SHORT)
    got = decoder.decode_views(*args, max_aspect=4.0)
    _equal(got, jax_decoder.decode_views(*args, max_aspect=4.0))
    assert got.shape[0] == 10
    for view in (0, 9):  # and the per-view seeks it replaces
        _equal(got[view], decoder.decode_clip(
            videos[name], 4, 2, view, 10, 30, SHORT, False, max_aspect=4.0))


def test_union_declines_sparse_views_for_good(tmp_path):
    """Views that cannot overlap (-16) raise UnionUnsupported, where JAX
    returns None (a failure it cannot tell from a transient one)."""
    path = str(tmp_path / "long.mp4")
    decoder.write_test_video(path, np.random.RandomState(9).randint(
        0, 255, (200, 18, 32, 3), np.uint8))
    with pytest.raises(decoder.UnionUnsupported) as err:
        decoder.decode_views(path, 8, 2, 10, 30, SHORT)
    assert err.value.rc == -16
    assert jax_decoder.decode_views(path, 8, 2, 10, 30, SHORT) is None
    assert decoder.decode_views(path + ".missing", 8, 2, 10, 30,
                                SHORT) is None  # a failure to open


@pytest.mark.parametrize("name", list(SHAPES))
def test_stream_matches_jax(videos, name):
    with decoder.VideoStream(videos[name], SHORT, max_aspect=4.0) as s:
        got = list(s)
        meta = (s.fps, s.nb_frames, s.duration, s.width, s.portrait)
    with jax_decoder.VideoStream(videos[name], SHORT, max_aspect=4.0) as s:
        want = list(s)
        assert meta == (s.fps, s.nb_frames, s.duration, s.width, s.portrait)
    assert len(got) == len(want) == SHAPES[name][0]
    for (p, f), (q, g) in zip(got, want):
        assert p == q
        _equal(f, g)


def test_encoder_output_decodes_alike_in_both_packages(tmp_path):
    rs = np.random.RandomState(3)
    path = str(tmp_path / "enc.mp4")
    with decoder.VideoEncoder(path, 40, 24, 15, gop=4) as enc:
        for _ in range(3):
            enc.append(rs.randint(0, 255, (5, 24, 40, 3), np.uint8))
        assert enc.frames_written == 15
        with pytest.raises(ValueError, match="encoder size"):
            enc.append(np.zeros((1, 20, 40, 3), np.uint8))
    assert decoder.probe(path) == jax_decoder.probe(path)
    assert decoder.probe(path)["nb_frames"] == 15
    for view in range(3):
        args = (path, 4, 2, view, 3, 15, 16, False)
        _equal(decoder.decode_clip(*args), jax_decoder.decode_clip(*args))
    got = [f for _, f in decoder.VideoStream(path, 16)]
    want = [f for _, f in jax_decoder.VideoStream(path, 16)]
    assert len(got) == len(want) == 15
    for f, g in zip(got, want):
        _equal(f, g)


# -- the three faults ---------------------------------------------------------
def test_a_library_lacking_a_bound_entry_point_is_rebuilt(tmp_path,
                                                          monkeypatch):
    """A library from before an entry point existed (here one that has
    esf_decode_clip2 only) is rebuilt. JAX's check asks for
    esf_decode_clip2 alone and would keep it."""
    stub = str(tmp_path / "libesf_decode.so")
    src = tmp_path / "stub.c"
    src.write_text("int esf_decode_clip2(void) { return 0; }\n")
    subprocess.run(["gcc", "-shared", "-fPIC", str(src), "-o", stub],
                   check=True)
    old = ctypes.CDLL(stub)
    assert hasattr(old, "esf_decode_clip2")  # what JAX's check asks for
    assert "esf_stream_open" in decoder.missing_symbols(old)
    _ctypes.dlclose(old._handle)
    built = []

    def build(dest=None):
        built.append(dest)
        tmp = dest + ".new"
        with open(decoder.lib_path(), "rb") as f, open(tmp, "wb") as g:
            g.write(f.read())  # the library built from the source
        os.replace(tmp, dest)
        return dest

    monkeypatch.setattr(decoder, "build", build)
    os.utime(stub, (os.path.getmtime(decoder.SOURCE) + 10,) * 2)  # not older
    lib = decoder.open_library(stub)
    assert built == [stub] and not decoder.missing_symbols(lib)


def _broken_stream(tmp_path):
    """(a fixture whose first P frame after the tenth has forward f_code 0
    in its header, which the mpeg4 decoder rejects as damaged; that
    frame's index)."""
    path = str(tmp_path / "src.mp4")
    decoder.write_test_video(path, np.random.RandomState(0).randint(
        0, 255, (40, 32, 48, 3), np.uint8), fps=30)
    data = bytearray(open(path, "rb").read())
    vops = [i for i in range(len(data) - 4)
            if data[i:i + 4] == b"\x00\x00\x01\xb6"]
    k = next(i for i in range(10, len(vops))
             if data[vops[i] + 4] >> 6 == 1)  # vop_coding_type P
    start = vops[k] + 4
    bits = np.unpackbits(np.frombuffer(bytes(data[start:start + 8]),
                                       np.uint8))
    pos = 2
    while bits[pos]:  # modulo_time_base
        pos += 1
    # its 0, marker, 5-bit time increment (30 fps), marker, vop_coded,
    # rounding type, intra_dc_vlc_thr, vop_quant
    pos += 1 + 1 + 5 + 1 + 1 + 1 + 3 + 5
    bits[pos:pos + 3] = 0  # vop_fcode_forward
    data[start:start + 8] = np.packbits(bits).tobytes()
    bad = str(tmp_path / "bad.mp4")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    return bad, k


def test_a_stream_that_fails_mid_way_raises(tmp_path):
    """JAX's stream ends quietly a frame short there, as if at its end;
    the port's raises."""
    bad, k = _broken_stream(tmp_path)
    assert len(list(jax_decoder.VideoStream(bad, SHORT))) == 39
    frames = 0
    with pytest.raises(RuntimeError, match="mid-stream"):
        for _ in decoder.VideoStream(bad, SHORT):
            frames += 1
    assert frames == k
