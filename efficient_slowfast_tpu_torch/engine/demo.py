"""Demo: sliding-window inference over a video file or a live frame stream
(port of ``engine/demo.py``; reference: tools/demo_net.py:26-399).

The window stream comes from DEMO.DATA_SOURCE: a video file decoded once,
in order, by the port's native decoder (``data/decoder.py``), or a live
camera when the source is an integer index (cv2.VideoCapture, imported only
there). Each window's uint8 frames are fitted to the canvas on the host and
go to the device as one tensor, with the content width and the centre
crop's spatial index; the preprocess and the forward (``make_forward``: the
fused engine with K1 under ``TPU.FUSED_EVAL``, K2 in CMDA's fusions, K3 in
the int8 convs under ``TPU.INT8_EVAL``) run there, and the scores come back
to the host before the window's clock is read, so the logged ``fps`` counts
the device's time. Each window logs a ``demo_window`` json line {window,
sec, top-k classes, scores, fps}; with DEMO.OUTPUT_FILE the annotated
windows are written through the native encoder, and DEMO.DISPLAY (or an
injected ``display`` sink) shows them. Tests inject synthetic streams
through the ``stream`` and ``capture`` parameters.

Detection (DETECTION.ENABLE): person boxes come from a DEMO.BOXES_FILE
json, ``{"<window_idx>": [[x1, y1, x2, y2], ...]}`` in normalized [0, 1]
coordinates of the raw frame, or live from the detector that
DEMO.DETECTOR_FN names ("module:symbol", called per window with the raw RGB
frames). The boxes are mapped onto the canvas, the RoI head scores each
one, and the overlay draws each box with its top action.

Two differences from the JAX package, on purpose:
- A mid-stream read or decode error of the file stream (the port's
  ``VideoStream`` raises there) replays the rest of the video through
  per-window seeks from the first window not yet finished, as a
  non-monotonic pts does. Windows already yielded stay; partial windows
  are dropped. The JAX package's stream ends quietly at a read error and
  finishes its open windows from partial frames, so those windows are not
  the seek path's.
- The port's forwards refuse an uncalibrated int8 model, so an int8 demo
  without a persisted calibration calibrates on its first window
  (``quantize.calibrate_int8``), persists it, and only then builds its
  forward.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data import decoder
from ..data.ava_dataset import MAX_BOXES
from ..data.datasets import canvas_width, fit_canvas
from ..data.preprocess import make_detection_preprocess, make_test_preprocess
from ..models import build_model
from ..models.build import get_compute_dtype, resolve_device
from ..parallel import distributed
from ..utils.checkpoint import load_test_checkpoint
from ..utils.logging import get_logger, log_json_stats, setup_logging
from ..utils.misc import load_demo_labels
from . import quantize
from .state import flatten_rois, make_detection_forward, make_forward

logger = get_logger(__name__)


def _is_camera_source(source) -> bool:
    """True when DEMO.DATA_SOURCE names a live camera index, not a file
    (reference demo_net.py:331: cv2.VideoCapture(int(source)))."""
    return isinstance(source, int) or (
        isinstance(source, str) and source.isdigit()
    )


def _open_camera(cfg):
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "DEMO.DATA_SOURCE is a camera index but cv2 is not "
            "available; install opencv-python or use a file source"
        ) from e
    cap = cv2.VideoCapture(int(cfg.DEMO.DATA_SOURCE))
    # requested capture resolution (reference demo_net.py:36-41)
    if cfg.DEMO.DISPLAY_WIDTH > 0 and cfg.DEMO.DISPLAY_HEIGHT > 0:
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, cfg.DEMO.DISPLAY_WIDTH)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, cfg.DEMO.DISPLAY_HEIGHT)
    return cap


def _make_display(cfg):
    """Live on-screen sink: (show, close) where ``show(frames_rgb)`` renders
    a (T, H, W, 3) uint8 clip and returns False when the user hit Esc
    (reference demo_net.py:71-75,393-397); only with ``DEMO.DISPLAY``, so
    headless runs never open a window."""
    if not cfg.DEMO.DISPLAY:
        return None, lambda: None
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "DEMO.DISPLAY requires cv2; install opencv-python or write to "
            "DEMO.OUTPUT_FILE instead"
        ) from e

    def show(frames: np.ndarray) -> bool:
        for f in frames:
            cv2.imshow("efficient-slowfast", np.ascontiguousarray(
                f[..., ::-1]))  # RGB -> cv2's BGR
            if cv2.waitKey(1) == 27:  # Esc quits
                return False
        return True

    return show, cv2.destroyAllWindows


def _capture_fps(capture) -> float:
    """Source frame rate of an open capture (cv2 CAP_PROP_FPS; 0/NaN on
    cameras that don't report one → 30)."""
    get = getattr(capture, "get", None)
    fps = 0.0
    if get is not None:
        try:
            import cv2

            fps = float(get(cv2.CAP_PROP_FPS) or 0.0)
        except Exception:
            fps = float(get(5) or 0.0)  # CAP_PROP_FPS == 5
    return fps if fps and np.isfinite(fps) else 30.0


def camera_window_stream(cfg, capture=None):
    """Yield (widx, frames) RGB uint8 windows from a live capture source.

    Buffers NUM_FRAMES×SAMPLING_RATE consecutive frames per window and keeps
    every SAMPLING_RATE-th, as the reference's webcam loop does
    (tools/demo_net.py:156-172). ``capture`` is anything with ``read() ->
    (ok, bgr_frame)`` (and optionally ``release()``): cv2.VideoCapture by
    default, a synthetic frame source in tests. Frames stay raw-sized: the
    demo loop's fit_canvas does the short-side resize.
    """
    if capture is None:
        capture = _open_camera(cfg)
    seq_len = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
    widx = 0
    buf = []
    try:
        while True:
            ok, frame = capture.read()
            if not ok:
                break
            buf.append(np.asarray(frame)[..., ::-1])  # BGR -> RGB
            if len(buf) == seq_len:
                yield widx, np.stack(buf[:: cfg.DATA.SAMPLING_RATE])
                widx += 1
                buf = []
    finally:
        release = getattr(capture, "release", None)
        if release is not None:
            release()


def _seek_window_stream(cfg, num_windows, start_widx=0):
    """Per-window selective-seek decode (one decode_clip per window), for
    containers the sequential stream cannot serve exactly; a window that
    does not decode is skipped."""
    for widx in range(start_widx, num_windows):
        frames = decoder.decode_clip(
            cfg.DEMO.DATA_SOURCE, cfg.DATA.NUM_FRAMES, cfg.DATA.SAMPLING_RATE,
            clip_idx=widx, num_clips=num_windows,
            target_fps=cfg.DATA.TARGET_FPS, short_side=cfg.DATA.TEST_CROP_SIZE,
            random_clip=False,
        )
        if frames is None:
            continue
        yield widx, frames


def file_window_stream(cfg, info=None):
    """Yield (widx, frames) windows from a video file.

    Decodes the file sequentially (decoder.VideoStream) and assembles each
    window from the frames streaming by, with the per-window pts bounds and
    linspace selection of the selective decoder (csrc esf_decode_clip2), so
    the windows are byte for byte the per-window seek path's while every
    source frame is decoded once (a seek pays a keyframe backoff of up to a
    GOP per window). Falls back to per-window seeks when the container
    lacks seek metadata or its pts are not strictly increasing, and from
    the first unfinished window on when the stream fails mid-way. ``info``
    reuses a ``decoder.probe`` result for the window count.
    """
    if info is None:
        info = decoder.probe(cfg.DEMO.DATA_SOURCE)
    assert info is not None, f"cannot open {cfg.DEMO.DATA_SOURCE}"
    fps = info["fps"] or 30.0
    clip_len_s = (cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE
                  / cfg.DATA.TARGET_FPS)
    duration_s = info["nb_frames"] / fps if info["nb_frames"] else 0
    num_windows = max(int(duration_s / max(clip_len_s, 1e-6)), 1)

    try:
        stream = decoder.VideoStream(
            cfg.DEMO.DATA_SOURCE, cfg.DATA.TEST_CROP_SIZE,
            multi_thread=cfg.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE)
    except RuntimeError:
        yield from _seek_window_stream(cfg, num_windows)
        return
    if not (stream.duration > 0 and stream.nb_frames > 0 and stream.fps > 0):
        stream.close()
        yield from _seek_window_stream(cfg, num_windows)
        return

    # per-window [start_pts, end_pts]: esf_decode_clip2's selective branch
    # at clip_idx=w, num_clips=num_windows
    t = cfg.DATA.NUM_FRAMES
    clip = (cfg.DATA.SAMPLING_RATE * t / cfg.DATA.TARGET_FPS) * stream.fps
    delta = max(stream.nb_frames - clip, 0)
    timebase = stream.duration / stream.nb_frames
    bounds = [(int((delta * w / num_windows) * timebase),
               int((delta * w / num_windows + clip - 1) * timebase))
              for w in range(num_windows)]

    def select(win):
        # linspace over the window's frame count (lround == floor(+0.5)
        # for the non-negative positions here)
        n = len(win)
        out = []
        for i in range(t):
            pos = 0.0 if t == 1 else (n - 1) * i / (t - 1)
            out.append(win[min(max(math.floor(pos + 0.5), 0), n - 1)])
        return np.stack(out)

    active = {}          # widx -> frames collected so far
    next_w = 0           # first window not yet activated
    done_w = 0           # windows finalized (yielded or skipped), in order
    last_pts = None
    with stream:
        while True:
            try:
                pts, frame = next(stream)
            except StopIteration:
                break
            except RuntimeError as e:
                # a packet failed to read or decode: the windows still open
                # would miss frames, so the seeks replay them
                logger.warning("%s: falling back to per-window seek decodes "
                               "from window %d", e, done_w)
                yield from _seek_window_stream(cfg, num_windows, done_w)
                return
            if last_pts is not None and pts <= last_pts:
                # non-monotonic pts: the pts-bound assembly would not match
                # the sorted seek windows
                logger.warning(
                    "non-monotonic pts in %s: falling back to per-window "
                    "seek decodes from window %d", cfg.DEMO.DATA_SOURCE,
                    done_w)
                yield from _seek_window_stream(cfg, num_windows, done_w)
                return
            last_pts = pts
            while next_w < num_windows and pts >= bounds[next_w][0]:
                active[next_w] = []
                next_w += 1
            # finalize in window order; bounds' ends are non-decreasing
            while done_w < next_w and done_w in active \
                    and bounds[done_w][1] < pts:
                win = active.pop(done_w)
                if win:
                    yield done_w, select(win)
                done_w += 1
            for w, win in active.items():
                if bounds[w][0] <= pts <= bounds[w][1]:
                    win.append(frame)
    while done_w < num_windows:
        win = active.pop(done_w, None)
        if win:
            yield done_w, select(win)
        done_w += 1


class _LazyWriter:
    """The annotated output of both demo paths: opens the native encoder at
    the first window (when the frame size is known) and appends per window,
    in constant memory over long streams. ``close`` (run in a finally)
    writes the mp4 trailer so an interrupted recording stays playable.
    No-op when ``path`` is empty."""

    def __init__(self, path: str, fps: float):
        self.path = path
        self.fps = fps
        self.frames_written = 0
        self._enc = None

    def write(self, frames: np.ndarray) -> None:
        if not self.path:
            return
        if self._enc is None:
            self._enc = decoder.VideoEncoder(
                self.path, frames.shape[2], frames.shape[1],
                round(self.fps))
        self._enc.append(frames)
        self.frames_written = self._enc.frames_written

    def close(self) -> None:
        if self._enc is not None:
            enc, self._enc = self._enc, None
            enc.close()
            logger.info("Wrote annotated video to %s (%d frames)",
                        self.path, enc.frames_written)


def _load_detector(cfg):
    """Resolve DEMO.DETECTOR_FN ("package.module:symbol") into a per-window
    detector ``fn(frames, window_idx) -> (N, 4)`` of normalized
    [x1, y1, x2, y2] boxes over the raw frame, clipped to [0, 1].

    The symbol may be a per-window function, a class instantiated once as
    ``cls(cfg)``, or a one-parameter factory ``make(cfg)`` returning the
    per-window callable, so detectors that load a model do so once (the
    counterpart of the reference's detectron2 predictor,
    tools/demo_net.py:130-146).
    """
    import importlib
    import inspect

    spec = cfg.DEMO.DETECTOR_FN
    mod_name, sep, attr_path = spec.partition(":")
    if not sep:
        mod_name, _, attr_path = spec.rpartition(".")
    if not mod_name or not attr_path:
        raise ValueError(
            f"DEMO.DETECTOR_FN={spec!r} — expected 'package.module:symbol'")
    try:
        obj = importlib.import_module(mod_name)
    except ImportError as e:
        raise RuntimeError(
            f"DEMO.DETECTOR_FN: cannot import module {mod_name!r} "
            f"(is it on PYTHONPATH?)") from e
    for part in attr_path.split("."):
        obj = getattr(obj, part)
    if inspect.isclass(obj):
        obj = obj(cfg)
    else:
        try:
            params = list(inspect.signature(obj).parameters)
        except (TypeError, ValueError):
            params = None
        if params == ["cfg"]:
            obj = obj(cfg)  # factory
    if not callable(obj):
        raise TypeError(
            f"DEMO.DETECTOR_FN={spec!r} resolved to a non-callable "
            f"{type(obj).__name__}")

    def detect(frames, widx):
        boxes = np.asarray(obj(frames, widx), np.float32)
        if boxes.size == 0:
            return np.zeros((0, 4), np.float32)
        if boxes.ndim != 2 or boxes.shape[1] != 4:
            raise ValueError(
                f"detector returned shape {boxes.shape} for window {widx}; "
                "expected (N, 4) normalized [x1,y1,x2,y2]")
        return np.clip(boxes, 0.0, 1.0)

    return detect


def _demo_calibrate(cfg, model, batch, widx) -> None:
    """Lazy first-window int8 calibration, persisted so that the next demo
    or test run loads it (calibrate once, serve many). ``batch`` is the
    pathway list, or (inputs, rois) for detection. In a job every rank
    calibrates on the window (its band of it under TPU.SPATIAL_SHARD),
    the ranges are the job's maxima, and the master persists them."""
    quant = quantize.calibrate_int8(model, [batch])
    if distributed.is_master():
        path = quantize.save_calibration(cfg, model, quant)
        logger.info("TPU.INT8_EVAL: calibrated activation ranges on window "
                    "%d; persisted to %s", widx, path)


def _file_or_camera_stream(cfg, stream):
    """(stream, the source's frame rate): ``stream`` where given; a camera
    index's capture, whose windows follow its own rate; else the file
    stream, which the decoder resamples to TARGET_FPS."""
    if stream is None and _is_camera_source(cfg.DEMO.DATA_SOURCE):
        capture = _open_camera(cfg)
        return camera_window_stream(cfg, capture), _capture_fps(capture)
    if stream is None:
        info = decoder.probe(cfg.DEMO.DATA_SOURCE)
        assert info is not None, f"cannot open {cfg.DEMO.DATA_SOURCE}"
        stream = file_window_stream(cfg, info)
    return stream, cfg.DATA.TARGET_FPS


def _job_windows(cfg, stream, prepare):
    """(this rank's windows, the source's frame rate); a window is (widx,
    frames, ``prepare(frames, widx)``), the payload a tuple of host arrays
    and numbers. In a process group the master alone opens the source (a
    camera opens once), prepares each window and broadcasts (widx,
    payload) over the gloo group, so that every rank serves the same
    window, as JAX replicates each window on its mesh; the other ranks'
    frames are None. The master's stream ending, or its loop leaving it
    (``close``), ends every rank's."""
    master = distributed.is_master()
    fps = None
    if master:
        source, fps = _file_or_camera_stream(cfg, stream)
    if distributed.world_size() == 1:
        return ((w, f, prepare(f, w)) for w, f in source), fps
    group = distributed.gloo_group()
    box = [fps]
    dist.broadcast_object_list(box, src=0, group=group)
    windows = (_broadcast_windows(source, prepare, group) if master
               else _received_windows(group))
    return windows, box[0]


def _broadcast_windows(source, prepare, group):
    try:
        for widx, frames in source:
            payload = prepare(frames, widx)
            dist.broadcast_object_list([(widx, payload)], src=0, group=group)
            yield widx, frames, payload
    finally:
        dist.broadcast_object_list([None], src=0, group=group)


def _received_windows(group):
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        if box[0] is None:
            return
        widx, payload = box[0]
        yield widx, None, payload


def demo(cfg, stream=None, display=None, device=None):
    """Run the sliding-window demo on ``device`` (the GPU by default,
    raising where there is none) and return the windows' entries.
    ``stream`` overrides the window source (an iterable of (widx, (T, H, W,
    3) uint8 RGB frames)) and ``display`` the DEMO.DISPLAY sink (a
    ``show(frames) -> bool`` callable, False to quit).

    In a job (``launch_job``; under ``TPU.SPATIAL_SHARD`` each rank
    serves its band of every window) the master reads the source and
    sends each window to the others (``_job_windows``), every rank runs
    the preprocess and the forward and returns the entries, and only the
    master draws, writes DEMO.OUTPUT_FILE and drives the display."""
    setup_logging(cfg.OUTPUT_DIR)
    assert stream is not None or cfg.DEMO.DATA_SOURCE or (
        isinstance(cfg.DEMO.DATA_SOURCE, int)
    ), "DEMO.DATA_SOURCE must point to a video file or camera index"

    dev = resolve_device(device)
    torch.manual_seed(cfg.RNG_SEED)
    model = build_model(cfg, dev)
    load_test_checkpoint(cfg, model)
    calibrated = not cfg.TPU.INT8_EVAL
    if cfg.TPU.INT8_EVAL:
        # a persisted serving calibration of this model and config, where
        # one exists; otherwise the loop calibrates on the first window
        quant = quantize.load_calibration(cfg, model)
        if quant is not None:
            quantize.load_quant_state(model, quant)
            calibrated = True
            logger.info("TPU.INT8_EVAL: loaded persisted calibration")

    labels = (load_demo_labels(cfg.DEMO.LABEL_FILE_PATH)
              if cfg.DEMO.LABEL_FILE_PATH else None)

    if cfg.DETECTION.ENABLE:
        return _demo_detection(cfg, model, dev, calibrated, labels,
                               display=display, stream=stream)
    preprocess = make_test_preprocess(cfg, get_compute_dtype(cfg))
    fwd = make_forward(cfg, model, dev) if calibrated else None

    # Each window keeps NUM_FRAMES frames spanning NUM_FRAMES*SAMPLING_RATE
    # source frames, so real-time playback of the annotated output is
    # source_rate/SAMPLING_RATE, and the window timestamps follow the
    # source's rate (the capture's for a camera).
    short = cfg.DATA.TEST_CROP_SIZE
    windows, src_fps = _job_windows(
        cfg, stream, lambda frames, widx: fit_canvas(frames, short)[:2])
    out_fps = src_fps / cfg.DATA.SAMPLING_RATE
    clip_len_s = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE / src_fps

    topk_n = cfg.TENSORBOARD.HISTOGRAM.TOPK or 3
    centre = torch.ones(1, dtype=torch.int64)
    results = []
    master = distributed.is_master()
    writer = _LazyWriter(cfg.DEMO.OUTPUT_FILE if master else "", out_fps)
    close_display = lambda: None  # noqa: E731
    if not master:
        display = None
    elif display is None:
        display, close_display = _make_display(cfg)
    if fwd is not None:
        # warm up on a dummy window so that window 0's fps measures the
        # inference, not cuDNN's autotune or a kernel library's first load
        # (an uncalibrated int8 model warms up on its first real window)
        warm = torch.zeros(1, cfg.DATA.NUM_FRAMES, short, canvas_width(short),
                           3, dtype=torch.uint8, device=dev)
        fwd(preprocess(warm, torch.tensor([short]), centre)).cpu()
    t0 = time.time()
    t_prev = t0
    try:
        for widx, frames, (canvas, width) in windows:
            inputs = preprocess(torch.from_numpy(canvas[None]).to(dev),
                                torch.tensor([width]), centre)
            if fwd is None:
                _demo_calibrate(cfg, model, inputs, widx)
                fwd = make_forward(cfg, model, dev)
            # the scores on the host before the clock is read: the window's
            # fps includes the device's time
            preds = fwd(inputs).float().cpu().numpy()[0]
            topk = np.argsort(-preds)[:topk_n]
            t_now = time.time()
            # frames/s over this window, like the reference's per-iteration
            # speed overlay (reference: tools/demo_net.py:240-255)
            win_fps = cfg.DATA.NUM_FRAMES / max(t_now - t_prev, 1e-6)
            t_prev = t_now
            entry = {
                "_type": "demo_window",
                "window": widx,
                "sec": round(widx * clip_len_s, 2),
                "top_classes": [labels[i] if labels else int(i)
                                for i in topk],
                "scores": [round(float(preds[i]), 4) for i in topk],
                "fps": round(win_fps, 1),
            }
            log_json_stats(entry)
            results.append(entry)
            if writer.path or display is not None:
                drawn = _annotate(frames, entry)
                writer.write(drawn)
                if display is not None and not display(drawn):
                    logger.info("Display quit (Esc) at window %d", widx)
                    break
    finally:
        # always release the display and finalize the mp4 (trailer): an
        # interrupted recording must stay playable
        windows.close()
        close_display()
        writer.close()
    fps_measured = len(results) * cfg.DATA.NUM_FRAMES / max(time.time() - t0, 1e-6)
    logger.info("Demo done: %d windows, %.1f frames/s", len(results), fps_measured)
    return results


def _demo_detection(cfg, model, dev, calibrated, labels, display=None,
                    stream=None):
    """Sliding-window action detection. Person boxes come from a
    DEMO.DETECTOR_FN live detector (per-window callable over the raw
    frames; the reference's detectron2 branch, tools/demo_net.py:130-146,
    with the detector pluggable) or a DEMO.BOXES_FILE json of precomputed
    normalized [x1, y1, x2, y2] boxes per window. In a job the master
    finds each window's boxes and sends them with its canvas."""
    master = distributed.is_master()
    get_boxes = None
    if not cfg.DEMO.DETECTOR_FN:
        assert cfg.DEMO.BOXES_FILE, (
            "detection demo needs person boxes: set DEMO.DETECTOR_FN "
            "('module:symbol' live detector) or DEMO.BOXES_FILE (json: "
            "window idx -> normalized [x1,y1,x2,y2] boxes)"
        )
        assert stream is not None or not _is_camera_source(
            cfg.DEMO.DATA_SOURCE), (
            "DEMO.BOXES_FILE holds per-window boxes of a known video, "
            "which a live camera cannot have. Set DEMO.DETECTOR_FN to run "
            "a live person detector (any detector plugs in), or use a "
            "file source"
        )
    if master and cfg.DEMO.DETECTOR_FN:
        get_boxes = _load_detector(cfg)
    elif master:
        with open(cfg.DEMO.BOXES_FILE) as f:
            boxes_by_window = {int(k): np.asarray(v, np.float32)
                               for k, v in json.load(f).items()}
        get_boxes = lambda frames, widx: boxes_by_window.get(  # noqa: E731
            widx, np.zeros((0, 4), np.float32))
    preprocess = make_detection_preprocess(cfg, get_compute_dtype(cfg))
    fwd = make_detection_forward(cfg, model, dev) if calibrated else None

    short = cfg.DATA.TEST_CROP_SIZE
    wc = canvas_width(short)
    windows, src_fps = _job_windows(
        cfg, stream, lambda frames, widx: _canvas_boxes(
            frames, get_boxes(frames, widx), widx, short, wc))
    clip_len_s = cfg.DATA.NUM_FRAMES * cfg.DATA.SAMPLING_RATE / src_fps

    results = []
    # windows hold NUM_FRAMES frames spanning NUM_FRAMES*SAMPLING_RATE
    # source frames: NUM_FRAMES/clip_len_s is that rate after subsampling
    writer = _LazyWriter(cfg.DEMO.OUTPUT_FILE if master else "",
                         cfg.DATA.NUM_FRAMES / clip_len_s)
    close_display = lambda: None  # noqa: E731
    if not master:
        display = None
    elif display is None:
        display, close_display = _make_display(cfg)
    if fwd is not None:
        # warm up so window 0's fps measures the inference (as the
        # classification path does)
        warm = torch.zeros(1, cfg.DATA.NUM_FRAMES, short, wc, 3,
                           dtype=torch.uint8, device=dev)
        fwd(preprocess(warm), torch.zeros(1, MAX_BOXES, 4)).cpu()
    t0 = time.time()
    try:
        _detection_window_loop(
            cfg, model, dev, fwd, preprocess, windows, clip_len_s, labels,
            results, writer, display)
    finally:
        windows.close()
        close_display()
        writer.close()
    fps_measured = (len(results) * cfg.DATA.NUM_FRAMES
                    / max(time.time() - t0, 1e-6))
    logger.info("Demo done: %d detection windows, %.1f frames/s",
                len(results), fps_measured)
    if writer.path and writer.frames_written == 0:
        logger.warning(
            "DEMO.OUTPUT_FILE set but no window produced frames "
            "(detector/boxes yielded nothing for any window?) — "
            "nothing written")
    return results


def _canvas_boxes(frames, nboxes, widx, short, wc):
    """(canvas, content width, boxes (MAX_BOXES, 4) in canvas pixels, the
    count of real boxes) of a window and its normalized boxes over the
    raw frame."""
    canvas, width, _ = fit_canvas(frames, short)
    if len(nboxes) > MAX_BOXES:
        logger.warning(
            "window %d: %d boxes exceed MAX_BOXES=%d; extra boxes "
            "dropped", widx, len(nboxes), MAX_BOXES)
    # normalized (over the raw frame) -> canvas pixels: undo the
    # fit_canvas resize and centre crops so boxes land on the content
    _, fh, fw, _ = frames.shape
    if fh <= fw:
        nh, nw = short, max(short, int(round(fw * short / fh)))
    else:
        nh, nw = int(round(fh * short / fw)), short
    yoff = max((nh - short) // 2, 0)
    xoff = max((nw - wc) // 2, 0)
    px = np.zeros((MAX_BOXES, 4), np.float32)
    n = min(len(nboxes), MAX_BOXES)
    px[:n, 0] = np.clip(nboxes[:n, 0] * nw - xoff, 0, width)
    px[:n, 1] = np.clip(nboxes[:n, 1] * nh - yoff, 0, short)
    px[:n, 2] = np.clip(nboxes[:n, 2] * nw - xoff, 0, width)
    px[:n, 3] = np.clip(nboxes[:n, 3] * nh - yoff, 0, short)
    return canvas, width, px, n


def _detection_window_loop(cfg, model, dev, fwd, preprocess, windows,
                           clip_len_s, labels, results, writer, display):
    topk_n = cfg.TENSORBOARD.HISTOGRAM.TOPK or 3
    t_prev = time.time()
    for widx, _, (canvas, width, px, n) in windows:
        if n == 0:
            # keep the output video time-continuous: pass the window
            # through un-annotated instead of dropping it
            writer.write(canvas)
            continue
        inputs = preprocess(torch.from_numpy(canvas[None]).to(dev))
        boxes = torch.from_numpy(px[None])
        if fwd is None:
            _demo_calibrate(cfg, model,
                            (inputs, flatten_rois(boxes.to(dev))), widx)
            fwd = make_detection_forward(cfg, model, dev)
        scores = fwd(inputs, boxes).float().cpu().numpy()[:n]
        t_now = time.time()
        win_fps = cfg.DATA.NUM_FRAMES / max(t_now - t_prev, 1e-6)
        t_prev = t_now
        box_entries = []
        for bi in range(n):
            topk = np.argsort(-scores[bi])[:topk_n]
            box_entries.append({
                "box": [round(float(v), 1) for v in px[bi]],
                "top_classes": [labels[i] if labels else int(i) for i in topk],
                "scores": [round(float(scores[bi][i]), 4) for i in topk],
            })
        entry = {
            "_type": "demo_window",
            "window": widx,
            "sec": round(widx * clip_len_s, 2),
            "boxes": box_entries,
            "fps": round(win_fps, 1),
        }
        log_json_stats(entry)
        results.append(entry)
        if writer.path or display is not None:
            # draw on the canvas (the coordinate frame the boxes live in)
            drawn = _annotate_boxes(canvas, entry)
            writer.write(drawn)
            if display is not None and not display(drawn):
                logger.info("Display quit (Esc) at window %d", widx)
                break


def _annotate_boxes(frames: np.ndarray, entry) -> np.ndarray:
    """Draw each person box and its top-1 action label (reference demo
    overlays detector boxes and action labels)."""
    from PIL import Image, ImageDraw

    out = np.empty_like(frames)
    for i in range(frames.shape[0]):
        im = Image.fromarray(frames[i])
        draw = ImageDraw.Draw(im)
        for be in entry["boxes"]:
            x1, y1, x2, y2 = be["box"]
            draw.rectangle([x1, y1, x2, y2], outline=(0, 255, 0))
            draw.text((x1 + 2, max(y1 - 10, 0)),
                      f"{be['top_classes'][0]}: {be['scores'][0]:.2f}",
                      fill=(0, 255, 0))
        out[i] = np.asarray(im)
    return out


def _annotate(frames: np.ndarray, entry) -> np.ndarray:
    """Overlay the top-k label lines and the measured fps onto each frame
    (reference: tools/demo_net.py:240-255,310-393 draws label and speed)."""
    from PIL import Image, ImageDraw

    out = np.empty_like(frames)
    lines = [
        f"{cls}: {score:.2f}"
        for cls, score in zip(entry["top_classes"], entry["scores"])
    ] + [f"Speed: {entry['fps']:.1f} fps"]
    for i in range(frames.shape[0]):
        im = Image.fromarray(frames[i])
        draw = ImageDraw.Draw(im)
        for li, text in enumerate(lines):
            draw.text((4, 4 + 12 * li), text, fill=(255, 255, 0))
        out[i] = np.asarray(im)
    return out
