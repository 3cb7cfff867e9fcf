"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package (its SlowFast forward, a tiny synthetic 30-view test, an I3D with
non-local blocks, the library attention blocks, a narrow ShuffleNetV2
and GhostNet, a detection forward with the AVA evaluator, and a video
decode with Grad-CAM and TensorBoard run in a process where importing them
raises), and it never falls back to the CPU without being asked."""

import ast
import os
import subprocess
import sys

import pytest

from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.engine.state import make_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "efficient_slowfast_tpu_torch")
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")

_TINY_FORWARD = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.engine.state import make_forward
cfg = get_cfg()
cfg.RESNET.WIDTH_PER_GROUP = 8
cfg.RESNET.DEPTH = 18
cfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2, 2], [2, 2], [2, 2], [2, 2]]
cfg.RESNET.SPATIAL_STRIDES = [[1, 1], [2, 2], [2, 2], [2, 2]]
cfg.RESNET.SPATIAL_DILATIONS = [[1, 1]] * 4
cfg.NONLOCAL.LOCATION = [[[], []]] * 4
cfg.SLOWFAST.ALPHA = 4
cfg.DATA.NUM_FRAMES = 4
cfg.DATA.CROP_SIZE = 32
cfg.MODEL.NUM_CLASSES = 5
cfg.TPU.COMPUTE_DTYPE = "float32"
cfg.TPU.FUSED_EVAL = True
torch.set_num_threads(1)
g = torch.Generator().manual_seed(0)
x = [torch.rand(1, 1, 32, 32, 3, generator=g),
     torch.rand(1, 4, 32, 32, 3, generator=g)]
out = make_forward(cfg, build_model(cfg, device="cpu"), device="cpu")(x)
assert out.shape == (1, 5) and abs(float(out.sum()) - 1.0) < 1e-4, out
# the data pipeline and the engines: a tiny synthetic 30-view test
import efficient_slowfast_tpu_torch.data.transform
import efficient_slowfast_tpu_torch.engine.train
import efficient_slowfast_tpu_torch.tools.run_net
import efficient_slowfast_tpu_torch.utils.checkpoint
import efficient_slowfast_tpu_torch.utils.lr_policy
import efficient_slowfast_tpu_torch.utils.profiler
from efficient_slowfast_tpu_torch.data.loader import construct_loader
from efficient_slowfast_tpu_torch.engine.test import perform_test
from efficient_slowfast_tpu_torch.utils.meters import TestMeter
cfg.TEST.DATASET = "synthetic"
cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS = 1, 3
cfg.TEST.BATCH_SIZE = 5
cfg.DATA.TEST_CROP_SIZE = 32
cfg.DATA_LOADER.NUM_WORKERS = 2
loader = construct_loader(cfg, "test")
meter = TestMeter(8, 3, 5, len(loader))
stats = perform_test(cfg, build_model(cfg, device="cpu"), loader, meter,
                     device="cpu")
assert stats["_type"] == "test_final", stats
assert abs(meter.video_preds.sum() - 24.0) < 1e-3, meter.video_preds
# the single-pathway ResNet with non-local blocks (softmax through
# flash_attention's plain version, dot_product), and the library blocks
from efficient_slowfast_tpu_torch.ops.attention import (
    ChannelAttention, ContextBlock3D, NonLocalBlock, StripeNonLocalBlock)
from efficient_slowfast_tpu_torch.utils.checkpoint import (
    load_caffe2_state_dict, load_matching)
for inst in ("softmax", "dot_product"):
    rcfg = get_cfg()
    rcfg.MODEL.MODEL_NAME, rcfg.MODEL.ARCH = "ResNet", "i3d"
    rcfg.MODEL.NUM_CLASSES = 5
    rcfg.RESNET.WIDTH_PER_GROUP, rcfg.RESNET.DEPTH = 8, 18
    rcfg.RESNET.TRANS_FUNC = "basic_transform"
    rcfg.RESNET.NUM_BLOCK_TEMP_KERNEL = [[2]] * 4
    rcfg.RESNET.SPATIAL_STRIDES = [[1], [2], [2], [2]]
    rcfg.RESNET.SPATIAL_DILATIONS = [[1]] * 4
    rcfg.NONLOCAL.LOCATION = [[[]], [[1]], [[1]], [[]]]
    rcfg.NONLOCAL.GROUP = [[1]] * 4
    rcfg.NONLOCAL.POOL = [[[1, 2, 2]]] * 4
    rcfg.NONLOCAL.INSTANTIATION = inst
    rcfg.DATA.INPUT_CHANNEL_NUM = [3]
    rcfg.DATA.NUM_FRAMES, rcfg.DATA.CROP_SIZE = 4, 32
    rcfg.TPU.COMPUTE_DTYPE = "float32"
    rcfg.TPU.FLASH_MIN_TOKENS = 8
    out = make_forward(rcfg, build_model(rcfg, device="cpu"), device="cpu")(
        [torch.rand(1, 4, 32, 32, 3, generator=g)])
    assert out.shape == (1, 5) and abs(float(out.sum()) - 1.0) < 1e-4, out
y = torch.rand(1, 8, 2, 4, 4)
for block in (ChannelAttention(8), NonLocalBlock(8), StripeNonLocalBlock(8, 2),
              ContextBlock3D(8)):
    assert block.eval()(y).shape == y.shape
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_port_imports_and_runs_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _TINY_FORWARD], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_EFFICIENT = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.engine.state import (
    create_train_state, make_forward, make_train_step)
from efficient_slowfast_tpu_torch.models import build_model
torch.set_num_threads(1)
cfg = load_cfg(sys.argv[1], ["MODEL.NUM_CLASSES", 5, "DATA.NUM_FRAMES", 8,
                             "DATA.CROP_SIZE", 32, "TPU.COMPUTE_DTYPE",
                             "float32", "TPU.FLASH_MIN_TOKENS", 16,
                             "SLOWFAST.WIDTH_MULTI", sys.argv[2]])
g = torch.Generator().manual_seed(0)
x = [torch.rand(2, 2, 32, 32, 3, generator=g),
     torch.rand(2, 8, 32, 32, 3, generator=g)]
out = make_forward(cfg, build_model(cfg, device="cpu"), device="cpu")(x)
assert out.shape == (2, 5) and bool(torch.isfinite(out).all()), out
state = create_train_state(cfg, build_model(cfg, device="cpu"), device="cpu")
step = make_train_step(cfg, state.model, state.optimizer)
loss = step(state, x, torch.tensor([1, 3]), 0.01, g)["loss"]
assert bool(torch.isfinite(loss)), loss
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


@pytest.mark.parametrize("yaml, width", [
    ("configs/Kinetics/SLOWFAST_SHUFFLENETV2_16x2_112.yaml", 0.25),
    ("configs/Kinetics/SLOWFAST_GHOSTNET_16x2_112.yaml", 0.5)])
def test_efficient_family_runs_without_jax(yaml, width):
    """A narrow ShuffleNetV2 and GhostNet from the zoo yamls serve and take
    a train step, their attention on the streaming path, with JAX
    blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _EFFICIENT, os.path.join(ROOT, yaml),
         str(width)], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_DETECTION = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu",
             "sklearn", "PIL"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import torch
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.data import ava_dataset, ava_helper
from efficient_slowfast_tpu_torch.engine.state import make_detection_forward
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.utils.ava_eval_helper import evaluate_ava
from efficient_slowfast_tpu_torch.utils.meters import get_map
torch.set_num_threads(1)
cfg = load_cfg(sys.argv[1], ["RESNET.WIDTH_PER_GROUP", 8, "DATA.NUM_FRAMES",
                             8, "TPU.COMPUTE_DTYPE", "float32"])
g = torch.Generator().manual_seed(0)
x = [torch.rand(2, 2, 32, 64, 3, generator=g),
     torch.rand(2, 8, 32, 64, 3, generator=g)]
boxes = torch.tensor([[[2.0, 3.0, 30.0, 28.0], [0.0, 0.0, 0.0, 0.0]],
                      [[10.0, 4.0, 50.0, 31.0], [40.0, 8.0, 58.0, 30.0]]])
fwd = make_detection_forward(cfg, build_model(cfg, device="cpu"), "cpu")
scores = fwd(x, boxes).numpy()
assert scores.shape == (4, 80) and ((scores > 0) & (scores < 1)).all()
keep = [0, 2, 3]
gt = ({"v0,0902": [[0.1, 0.0, 0.9, 0.5]], "v1,0902": [[0.1, 0.2, 1.0, 0.8],
       [0.25, 0.6, 0.95, 0.9]]},
      {"v0,0902": [5], "v1,0902": [5, 12]}, {})
ori = np.array([[0, 0.0, 0.1, 0.5, 0.9], [0, 0.2, 0.1, 0.8, 1.0],
                [0, 0.6, 0.25, 0.9, 0.95]])
m = evaluate_ava(scores[keep], ori, np.array([[0, 902], [1, 902], [1, 902]]),
                 set(), {5, 12}, [{"id": 5, "name": "a"},
                                  {"id": 12, "name": "b"}],
                 groundtruth=gt, video_idx_to_name=["v0", "v1"])
assert 0.0 <= m <= 1.0, m
assert 0.0 <= get_map(scores, (scores > 0.5).astype(int)) <= 1.0
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu",
        "sklearn", "PIL") and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_detection_runs_without_jax_sklearn_or_pil():
    """A narrow SlowFast of the AVA yaml scores boxes through
    make_detection_forward, and the AVA evaluator and get_map run, with
    JAX, sklearn and PIL blocked (PIL is needed only to read JPEGs)."""
    proc = subprocess.run(
        [sys.executable, "-c", _DETECTION,
         os.path.join(ROOT, "configs/AVA/SLOWFAST_32x2_R50_SHORT.yaml")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_FRAME_DATA = r"""
import os, sys
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
from PIL import Image
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.data.build import build_dataset
from efficient_slowfast_tpu_torch.utils.benchmark import benchmark_data_loading
root = sys.argv[1]
for v in range(2):
    os.makedirs(os.path.join(root, f"v{v}"))
    for i in range(6):
        Image.fromarray(np.full((30, 40, 3), 20 * i + v, np.uint8)).save(
            os.path.join(root, f"v{v}", f"{i}.jpg"))
with open(os.path.join(root, "train.txt"), "w") as f:
    f.write("v0 0\nv1 1\n")
cfg = get_cfg()
cfg.DATA.PATH_TO_DATA_DIR = cfg.DATA.PATH_PREFIX = root
cfg.DATA.NUM_FRAMES, cfg.DATA.TRAIN_JITTER_SCALES = 4, [16, 20]
cfg.TRAIN.DATASET, cfg.TRAIN.BATCH_SIZE = "wheel_gray", 2
cfg.BENCHMARK.NUM_EPOCHS, cfg.DATA_LOADER.NUM_WORKERS = 1, 2
item = build_dataset("wheel_gray", cfg, "train")[1]
assert item["frames"].shape == (4, 20, 40, 3) and int(item["width"]) == 20
assert len(benchmark_data_loading(cfg)) == 1
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_frame_datasets_run_without_jax(tmp_path):
    """A gray-style frame-folder item and the data-loading benchmark, with
    JAX blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _FRAME_DATA, str(tmp_path)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_SERVING = r"""
import sys
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
import efficient_slowfast_tpu_torch.engine.export
import efficient_slowfast_tpu_torch.tools.export_serving
from efficient_slowfast_tpu_torch.config import get_cfg
from efficient_slowfast_tpu_torch.engine.quantize import (
    calibrate_int8, load_calibration, save_calibration)
from efficient_slowfast_tpu_torch.ops.conv import Conv3d, enable_int8
from efficient_slowfast_tpu_torch.ops.kernels.int8_conv import int8_conv
cfg = get_cfg()
cfg.TPU.INT8_EVAL = cfg.TPU.INT8_SPATIAL = True
cfg.OUTPUT_DIR = sys.argv[1]
conv = enable_int8(Conv3d(3, 8, (1, 3, 3), padding=(0, 1, 1)), cfg)
x = torch.randn(2, 3, 2, 8, 8, generator=torch.Generator().manual_seed(0))
quant = calibrate_int8(conv, [(x,)])
save_calibration(cfg, conv, quant)
assert load_calibration(cfg, conv).keys() == quant.keys()
with torch.no_grad():
    y = conv(x)
assert y.shape == (2, 8, 2, 8, 8) and int8_conv.launches == 0
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")
       and sys.modules[m] is not None]
assert not bad, bad
print("OK")
"""


def test_int8_serving_and_export_run_without_jax(tmp_path):
    """engine/quantize.py, engine/export.py, ops/kernels/int8_conv.py and
    tools/export_serving.py import, and an int8 conv calibrates, persists
    its range and serves, with JAX blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _SERVING, str(tmp_path)], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


_VIDEO_AND_VIS = r"""
import os, sys, types
for name in ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
# tensorboard's switch to its TensorFlow stub (TensorFlow imports slowly)
sys.modules["tensorboard.compat.notf"] = types.ModuleType("notf")
import numpy as np
import torch
from efficient_slowfast_tpu_torch.config import load_cfg
from efficient_slowfast_tpu_torch.data import decoder
from efficient_slowfast_tpu_torch.models import build_model
from efficient_slowfast_tpu_torch.visualization import GradCAM, TensorboardWriter
from efficient_slowfast_tpu_torch.visualization.video_cam import gradcam_clip
root, yaml, port_build = sys.argv[1:4]
torch.set_num_threads(1)
path = os.path.join(root, "clip.mp4")
decoder.write_test_video(path, np.random.RandomState(0).randint(
    0, 255, (24, 40, 48, 3), np.uint8))
clip = decoder.decode_clip(path, 8, 2, 0, 1, 30, 32, False)
assert clip.shape == (8, 32, 38, 3), clip.shape
lib = os.path.realpath(decoder.get_lib()._name)
assert os.path.dirname(lib) == os.path.realpath(port_build), lib
cfg = load_cfg(yaml, ["OUTPUT_DIR", root])
model = build_model(cfg, device="cpu")
out = gradcam_clip(cfg, model, clip, "s3")
assert [o.shape for o in out["overlays"]] == [(2, 32, 32, 3), (8, 32, 32, 3)]
writer = TensorboardWriter(cfg)
writer.add_scalars({"Train/loss": 1.5}, global_step=0)
writer.plot_eval(np.eye(10)[[0, 1, 2, 2]], np.array([0, 1, 2, 3]), 0)
writer.close()
assert os.listdir(os.path.join(root, "runs-synthetic"))
loaded = [m for m in sys.modules if m.split(".")[0] in
          ("jax", "flax", "optax", "msgpack", "efficient_slowfast_tpu")
          and sys.modules[m] is not None]
assert not loaded, loaded
print("OK")
"""


def test_video_decode_gradcam_and_tensorboard_run_without_jax(tmp_path):
    """A fixture video decodes through the port's own library (built
    under build/torch_decode/, never the JAX package's), Grad-CAM of a
    tiny ShuffleNetV2 overlays its clip, and TensorBoard events are
    written, with JAX blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", _VIDEO_AND_VIS, str(tmp_path),
         os.path.join(ROOT, "configs/Synthetic/SHUFFLENETV2_TINY.yaml"),
         os.path.join(ROOT, "build", "torch_decode")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def _python_files():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = list(_python_files())
    assert len(files) > 15
    # the distribution runtime is walked too
    assert os.path.join(PORT, "parallel", "distributed.py") in files
    bad = [(os.path.relpath(p, ROOT), m) for p in files for m in _imports(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_no_device_given_and_no_gpu_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_forward(cfg, torch.nn.Identity())


def test_the_engines_need_a_gpu_unless_asked(monkeypatch, tmp_path):
    import torch

    from efficient_slowfast_tpu_torch.engine.test import perform_test, test

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.TEST.DATASET = "synthetic"
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        perform_test(cfg, torch.nn.Identity(), [], None)

    from efficient_slowfast_tpu_torch.engine.train import train
    from efficient_slowfast_tpu_torch.tools.run_net import main

    cfg.TRAIN.DATASET = "synthetic"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic",
              "OUTPUT_DIR", str(tmp_path)])
