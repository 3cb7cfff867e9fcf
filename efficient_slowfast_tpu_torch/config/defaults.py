"""Default config tree of the PyTorch/CUDA port.

A copy of ``efficient_slowfast_tpu/config/defaults.py`` with every key kept,
the ``TPU`` node included, so that the YAML zoo under ``configs/`` merges
unchanged into either package. The port reads ``TPU.COMPUTE_DTYPE`` and
``TPU.FUSED_EVAL`` under their existing names and adds no keys of its own;
the keys that only the JAX package acts on are accepted and ignored here.

Key surface mirrors the reference config system (reference:
slowfast/config/defaults.py:12-643 and slowfast/config/custom_config.py:7-35).
"""

from __future__ import annotations

from .node import CfgNode

_C = CfgNode()

# ---------------------------------------------------------------------------
# BatchNorm options (reference: defaults.py BN group)
# ---------------------------------------------------------------------------
_C.BN = CfgNode()
_C.BN.USE_PRECISE_STATS = False
_C.BN.NUM_BATCHES_PRECISE = 200
_C.BN.WEIGHT_DECAY = 0.0
# "batchnorm" | "sub_batchnorm" | "sync_batchnorm"
_C.BN.NORM_TYPE = "batchnorm"
_C.BN.NUM_SPLITS = 1
_C.BN.NUM_SYNC_DEVICES = 1
_C.BN.EPSILON = 1e-5
_C.BN.MOMENTUM = 0.1  # torch convention: new = (1-m)*old + m*batch

# ---------------------------------------------------------------------------
# Training options
# ---------------------------------------------------------------------------
_C.TRAIN = CfgNode()
_C.TRAIN.ENABLE = True
_C.TRAIN.DATASET = "kinetics"
_C.TRAIN.BATCH_SIZE = 64
_C.TRAIN.EVAL_PERIOD = 1
_C.TRAIN.CHECKPOINT_PERIOD = 1
_C.TRAIN.AUTO_RESUME = True
_C.TRAIN.CHECKPOINT_FILE_PATH = ""
# "pytorch" | "caffe2" | "jax"
_C.TRAIN.CHECKPOINT_TYPE = "pytorch"
_C.TRAIN.CHECKPOINT_INFLATE = False
_C.TRAIN.TOPK = 5  # reference: custom_config.py TRAIN.TOPK

# ---------------------------------------------------------------------------
# Testing options
# ---------------------------------------------------------------------------
_C.TEST = CfgNode()
_C.TEST.ENABLE = True
_C.TEST.DATASET = "kinetics"
_C.TEST.BATCH_SIZE = 8
_C.TEST.CHECKPOINT_FILE_PATH = ""
_C.TEST.NUM_ENSEMBLE_VIEWS = 10
_C.TEST.NUM_SPATIAL_CROPS = 3
_C.TEST.CHECKPOINT_TYPE = "pytorch"

# ---------------------------------------------------------------------------
# ResNet options
# ---------------------------------------------------------------------------
_C.RESNET = CfgNode()
_C.RESNET.TRANS_FUNC = "bottleneck_transform"
_C.RESNET.NUM_GROUPS = 1
_C.RESNET.WIDTH_PER_GROUP = 64
_C.RESNET.INPLACE_RELU = True  # no-op in JAX; kept for YAML compat
_C.RESNET.STRIDE_1X1 = False
_C.RESNET.ZERO_INIT_FINAL_BN = False
_C.RESNET.DEPTH = 50
_C.RESNET.NUM_BLOCK_TEMP_KERNEL = [[3], [4], [6], [3]]
_C.RESNET.SPATIAL_STRIDES = [[1], [2], [2], [2]]
_C.RESNET.SPATIAL_DILATIONS = [[1], [1], [1], [1]]

# ---------------------------------------------------------------------------
# Non-local options
# ---------------------------------------------------------------------------
_C.NONLOCAL = CfgNode()
_C.NONLOCAL.LOCATION = [[[]], [[]], [[]], [[]]]
_C.NONLOCAL.GROUP = [[1], [1], [1], [1]]
_C.NONLOCAL.INSTANTIATION = "dot_product"
_C.NONLOCAL.POOL = [
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
    [[1, 2, 2], [1, 2, 2]],
]

# ---------------------------------------------------------------------------
# Model options
# ---------------------------------------------------------------------------
_C.MODEL = CfgNode()
_C.MODEL.ARCH = "slowfast"
_C.MODEL.MODEL_NAME = "SlowFast"
_C.MODEL.NUM_CLASSES = 400
_C.MODEL.LOSS_FUNC = "cross_entropy"
# Reference custom_config.py:32 ships ["c2d", "i3d", "slow", "fast"], which
# makes its own c2/C2D_NOPOOL_8x8_R50.yaml unbuildable; the nopool archs are
# listed upstream and our model tables support them, so include them here.
_C.MODEL.SINGLE_PATHWAY_ARCH = ["c2d", "c2d_nopool", "i3d", "i3d_nopool", "slow", "fast"]
_C.MODEL.MULTI_PATHWAY_ARCH = ["slowfast"]
_C.MODEL.DROPOUT_RATE = 0.5
_C.MODEL.FC_INIT_STD = 0.01
_C.MODEL.HEAD_ACT = "softmax"
_C.MODEL.WEIGHTED_RANDOM_SAMPLER = False
# Classify from the SLOW pathway only while consuming both pathways
# (reference: head_helper.py:269-418 ResNetBasicHead_SlowPath)
_C.MODEL.SLOW_PATHWAY_HEAD = False

# ---------------------------------------------------------------------------
# SlowFast options
# ---------------------------------------------------------------------------
_C.SLOWFAST = CfgNode()
_C.SLOWFAST.BETA_INV = 8
_C.SLOWFAST.ALPHA = 8
_C.SLOWFAST.FUSION_CONV_CHANNEL_RATIO = 2
_C.SLOWFAST.FUSION_KERNEL_SZ = 5
_C.SLOWFAST.WIDTH_MULTI = 2.0  # efficient-backbone width multiplier
_C.SLOWFAST.GROUPS = 1  # ShuffleNet(v1) group count

# ---------------------------------------------------------------------------
# Data options
# ---------------------------------------------------------------------------
_C.DATA = CfgNode()
_C.DATA.PATH_TO_DATA_DIR = ""
_C.DATA.PATH_LABEL_SEPARATOR = " "
_C.DATA.PATH_PREFIX = ""
_C.DATA.CROP_SIZE = 224
_C.DATA.NUM_FRAMES = 8
_C.DATA.SAMPLING_RATE = 8
_C.DATA.MEAN = [0.45, 0.45, 0.45]
_C.DATA.INPUT_CHANNEL_NUM = [3, 3]
_C.DATA.STD = [0.225, 0.225, 0.225]
_C.DATA.TRAIN_JITTER_SCALES = [256, 320]
_C.DATA.TRAIN_CROP_SIZE = 224
_C.DATA.TEST_CROP_SIZE = 256
_C.DATA.TARGET_FPS = 30
# "ffmpeg" (native C++ decoder) | "synthetic" (random frames, for tests/bench)
_C.DATA.DECODING_BACKEND = "ffmpeg"
_C.DATA.INV_UNIFORM_SAMPLE = False
# [lo, hi] PIL-enhancement-factor range for clip-level train color jitter
# (empty = off; jester uses [0.4, 1.4] — reference decoder.py:447-454)
_C.DATA.TRAIN_COLOR_JITTER = []
_C.DATA.RANDOM_FLIP = True
_C.DATA.MULTI_LABEL = False
_C.DATA.ENSEMBLE_METHOD = "sum"  # "sum" | "max"
_C.DATA.REVERSE_INPUT_CHANNEL = False
_C.DATA.PATH_TO_TRAIN_DATA_TXT = ""
_C.DATA.PATH_TO_VAL_DATA_TXT = ""
_C.DATA.HALF_FACE = False
# Frame-folder gray-style pipeline: grayscale + random corner crop + square
# resize + rotate/salt-noise train augmentation (reference: decoder.py
# wheel/smoke_decoder_gray_style :607-1041)
_C.DATA.GRAY_STYLE = False
# Slow pathway = contiguous middle T//α window instead of strided subsample
# (reference: datasets/utils.py:115-148 pack_pathway_output_in_the_middle)
_C.DATA.SLOW_PATHWAY_MIDDLE = False

# ---------------------------------------------------------------------------
# Optimizer options
# ---------------------------------------------------------------------------
_C.SOLVER = CfgNode()
_C.SOLVER.BASE_LR = 0.1
_C.SOLVER.LR_POLICY = "cosine"
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEP_SIZE = 1  # declared-but-unused upstream too (no reader in reference)
_C.SOLVER.STEPS = []
_C.SOLVER.LRS = []
_C.SOLVER.MAX_EPOCH = 300
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.DAMPENING = 0.0
_C.SOLVER.NESTEROV = True
_C.SOLVER.WEIGHT_DECAY = 1e-4
_C.SOLVER.WARMUP_FACTOR = 0.1  # declared-but-unused upstream too; warmup uses WARMUP_START_LR
_C.SOLVER.WARMUP_EPOCHS = 0.0
_C.SOLVER.WARMUP_START_LR = 0.01
_C.SOLVER.OPTIMIZING_METHOD = "sgd"

# ---------------------------------------------------------------------------
# Misc options
# ---------------------------------------------------------------------------
_C.NUM_GPUS = 1  # processes (one per GPU) on each machine
_C.NUM_SHARDS = 1
_C.SHARD_ID = 0
_C.OUTPUT_DIR = "./tmp"
_C.RNG_SEED = 1
_C.LOG_PERIOD = 10
_C.LOG_MODEL_INFO = True
_C.DIST_BACKEND = "nccl"  # nccl on GPUs, gloo for CPU processes

# ---------------------------------------------------------------------------
# Benchmark options
# ---------------------------------------------------------------------------
_C.BENCHMARK = CfgNode()
_C.BENCHMARK.NUM_EPOCHS = 5
_C.BENCHMARK.LOG_PERIOD = 100
_C.BENCHMARK.SHUFFLE = True

# ---------------------------------------------------------------------------
# Data-loader options
# ---------------------------------------------------------------------------
_C.DATA_LOADER = CfgNode()
_C.DATA_LOADER.NUM_WORKERS = 8
_C.DATA_LOADER.PIN_MEMORY = True
_C.DATA_LOADER.ENABLE_MULTI_THREAD_DECODE = False
_C.DATA_LOADER.PREFETCH_DEPTH = 2  # TPU addition: device prefetch depth

# ---------------------------------------------------------------------------
# Detection (AVA) options
# ---------------------------------------------------------------------------
_C.DETECTION = CfgNode()
_C.DETECTION.ENABLE = False
_C.DETECTION.ALIGNED = True
_C.DETECTION.SPATIAL_SCALE_FACTOR = 16
_C.DETECTION.ROI_XFORM_RESOLUTION = 7

# ---------------------------------------------------------------------------
# AVA dataset options
# ---------------------------------------------------------------------------
_C.AVA = CfgNode()
_C.AVA.FRAME_DIR = ""
_C.AVA.FRAME_LIST_DIR = ""
_C.AVA.ANNOTATION_DIR = ""
_C.AVA.TRAIN_LISTS = ["train.csv"]
_C.AVA.TEST_LISTS = ["val.csv"]
_C.AVA.TRAIN_GT_BOX_LISTS = ["ava_train_v2.2.csv"]
_C.AVA.TRAIN_PREDICT_BOX_LISTS = []
_C.AVA.TEST_PREDICT_BOX_LISTS = ["ava_val_predicted_boxes.csv"]
_C.AVA.DETECTION_SCORE_THRESH = 0.9
_C.AVA.BGR = False
_C.AVA.TRAIN_USE_COLOR_AUGMENTATION = False
_C.AVA.TRAIN_PCA_JITTER_ONLY = True
_C.AVA.TRAIN_PCA_EIGVAL = [0.225, 0.224, 0.229]
_C.AVA.TRAIN_PCA_EIGVEC = [
    [-0.5675, 0.7192, 0.4009],
    [-0.5808, -0.0045, -0.8140],
    [-0.5836, -0.6948, 0.4203],
]
_C.AVA.TEST_FORCE_FLIP = False
_C.AVA.FULL_TEST_ON_VAL = False
_C.AVA.LABEL_MAP_FILE = "ava_action_list_v2.2_for_activitynet_2019.pbtxt"
_C.AVA.EXCLUSION_FILE = "ava_val_excluded_timestamps_v2.2.csv"
_C.AVA.GROUNDTRUTH_FILE = "ava_val_v2.2.csv"
_C.AVA.IMG_PROC_BACKEND = "cv2"  # kept for YAML compat; TPU build uses PIL/np

# ---------------------------------------------------------------------------
# Multigrid options
# ---------------------------------------------------------------------------
_C.MULTIGRID = CfgNode()
_C.MULTIGRID.EPOCH_FACTOR = 1.5
_C.MULTIGRID.SHORT_CYCLE = False
_C.MULTIGRID.SHORT_CYCLE_FACTORS = [0.5, 0.5**0.5]
_C.MULTIGRID.LONG_CYCLE = False
_C.MULTIGRID.LONG_CYCLE_FACTORS = [
    [0.25, 0.5**0.5],
    [0.5, 0.5**0.5],
    [0.5, 1.0],
    [1.0, 1.0],
]
_C.MULTIGRID.BN_BASE_SIZE = 8
_C.MULTIGRID.EVAL_FREQ = 3
_C.MULTIGRID.LONG_CYCLE_SAMPLING_RATE = 0
_C.MULTIGRID.DEFAULT_B = 0
_C.MULTIGRID.DEFAULT_T = 0
_C.MULTIGRID.DEFAULT_S = 0

# ---------------------------------------------------------------------------
# TensorBoard options
# ---------------------------------------------------------------------------
_C.TENSORBOARD = CfgNode()
_C.TENSORBOARD.ENABLE = False
_C.TENSORBOARD.LOG_DIR = ""
_C.TENSORBOARD.CLASS_NAMES_PATH = ""
_C.TENSORBOARD.CATEGORIES_PATH = ""
_C.TENSORBOARD.CONFUSION_MATRIX = CfgNode()
_C.TENSORBOARD.CONFUSION_MATRIX.ENABLE = False
_C.TENSORBOARD.CONFUSION_MATRIX.FIGSIZE = [8, 8]
_C.TENSORBOARD.CONFUSION_MATRIX.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM = CfgNode()
_C.TENSORBOARD.HISTOGRAM.ENABLE = False
_C.TENSORBOARD.HISTOGRAM.SUBSET_PATH = ""
_C.TENSORBOARD.HISTOGRAM.TOPK = 3
_C.TENSORBOARD.HISTOGRAM.FIGSIZE = [8, 8]
_C.TENSORBOARD.MODEL_VIS = CfgNode()
_C.TENSORBOARD.MODEL_VIS.ENABLE = False

# ---------------------------------------------------------------------------
# Demo options
# ---------------------------------------------------------------------------
_C.DEMO = CfgNode()
_C.DEMO.ENABLE = False
_C.DEMO.LABEL_FILE_PATH = ""
_C.DEMO.DATA_SOURCE = ""
_C.DEMO.DISPLAY_WIDTH = 0
_C.DEMO.DISPLAY_HEIGHT = 0
# Show annotated frames live via cv2.imshow (Esc quits). The reference
# displays whenever no output file is set (demo_net.py:71-75); here it is
# an explicit opt-in so headless runs never pop windows.
_C.DEMO.DISPLAY = False
# live person-detector integration is out of scope (precomputed boxes
# by design, SURVEY 2.8); keys kept so reference demo YAMLs parse.
_C.DEMO.DETECTRON2_OBJECT_DETECTION_MODEL_CFG = ""
_C.DEMO.DETECTRON2_OBJECT_DETECTION_MODEL_WEIGHTS = ""
_C.DEMO.OUTPUT_FILE = ""
# Detection demo: json file of precomputed person boxes per sliding window
# ({"<window_idx>": [[x1,y1,x2,y2], ...]} normalized to [0,1]); replaces
# the reference's live detectron2 person detector (external model).
_C.DEMO.BOXES_FILE = ""
# Pluggable live person detector: "package.module:symbol" resolved at demo
# start. The symbol is a per-window callable ``fn(frames, window_idx) ->
# (N, 4) normalized [x1,y1,x2,y2]`` (frames: (T,H,W,3) uint8 RGB), a class
# instantiated once as ``cls(cfg)`` whose instance is that callable, or a
# one-parameter factory ``make(cfg)`` returning it. Generalizes the
# reference's bundled detectron2 predictor (tools/demo_net.py:130-146) to
# any detector, and unlike BOXES_FILE it works on live camera sources.
_C.DEMO.DETECTOR_FN = ""

# ---------------------------------------------------------------------------
# TPU-specific options (new in this framework)
# ---------------------------------------------------------------------------
_C.TPU = CfgNode()
# Compute dtype for conv/matmul ("bfloat16" for speed, "float32" for parity runs).
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# Mesh axis sizes; data axis defaults to all local devices when 0.
_C.TPU.DATA_AXIS = 0
# Spatial (height) model parallelism: shard frame H over a second "space"
# mesh axis of this size (0/1 = off). GSPMD inserts conv halo exchanges;
# same computation, split activations — for configs whose T*H*W
# activations don't fit one chip even at batch 1 (parallel/mesh.py).
_C.TPU.SPATIAL_SHARD = 0
# Use donated buffers in the train step.
_C.TPU.DONATE = True
# Steps between host metric syncs (device-accumulated metrics).
_C.TPU.METRICS_PERIOD = 10
# Rematerialize residual stages in backward (trade FLOPs for HBM; enables
# larger train batches).
_C.TPU.REMAT = False
# With REMAT on, limit rematerialization to these stages (2..5); empty =
# all stages. The early high-resolution stages hold most activation
# memory — rematting only them keeps batch headroom without recomputing
# s4/s5 in backward (PERF.md round-3 train sweep).
_C.TPU.REMAT_STAGES = []
# Gradient accumulation: split each train batch into N sequential
# microbatches inside the jitted step (grads averaged, ONE optimizer
# update; BN batch statistics update per microbatch, so BN sees batches of
# B/N — the same semantics as torch-style accumulation over N loader
# steps). Trades step latency for activation memory: peak activations
# scale with B/N while the optimizer math sees the full batch B.
# Applies to the classification AND the detection (AVA) train step; the
# detection step accumulates the UNNORMALIZED masked loss sums and divides
# by the total box-mask count so uneven masks across microbatches still
# reproduce the full-batch gradient exactly (engine/state.py).
_C.TPU.GRAD_ACCUM_STEPS = 1
# Dtype for optimizer moment buffers (SGD momentum / Adam moments).
# "bfloat16" halves optimizer-state HBM at a small statistics-precision
# cost (updates are still computed in f32; only storage is cast).
_C.TPU.OPTIMIZER_STATE_DTYPE = "float32"
# Log a per-module params/FLOPs table at model build (flax nn.tabulate over
# XLA cost analysis; stand-in for the reference's ptflops per-layer stats,
# reference: misc.py:153-162).
_C.TPU.LOG_FLOPS_PER_LAYER = False
# Decompose low-channel full-3D stem convs into per-temporal-tap 2D convs
# (faster in isolation, loses end-to-end by breaking XLA fusion; opt-in).
_C.TPU.TAP_DECOMPOSE = False
# Rewrite stride-2 7x7 tiny-C_in stems via space-to-depth with the 4x4
# output-pixel block packed into conv output channels (1.5x the fast stem
# on v5e; exact rewrite, checkpoint-compatible).
_C.TPU.STEM_D2S = False
# Serve 1x1x1 convs as calibrated int8 matmuls during eval (int8 MXU path;
# throughput measured by bench.py --mode int8, PERF.md round 4). Requires a
# calibration pass (engine/quantize.py::calibrate_int8) to record per-layer
# activation ranges; the test/demo engines auto-calibrate on the first
# INT8_CALIB_BATCHES batches. Serving-only: incompatible with TRAIN.ENABLE.
# Accuracy delta is reported by bench.py --mode int8.
_C.TPU.INT8_EVAL = False
# Test-loader batches used for the automatic activation-range calibration.
_C.TPU.INT8_CALIB_BATCHES = 1
# Extend INT8_EVAL to the spatial (k>1) convs as well — the slow pathway's
# bandwidth-bound 3x3 stack (PERF.md). Bigger byte cut, bigger accuracy
# risk than the pointwise-only path; measured by bench.py --mode int8.
# No effect unless TPU.INT8_EVAL is also set.
_C.TPU.INT8_SPATIAL = False
# Use the Pallas flash-attention kernel on TPU for large token counts.
_C.TPU.FLASH_ATTENTION = True
# Token count above which attention uses the streaming (flash/chunked) path
# instead of materializing the (N, N) affinity.
_C.TPU.FLASH_MIN_TOKENS = 1024
# Largest key count dispatched to the Pallas kernel (Mosaic-validated bound
# on v5e; larger sizes use the chunked lax.scan path).
_C.TPU.FLASH_MAX_KEYS = 25088
# Serve eval through the fused inference engine (folded BN + Pallas fused
# bottleneck blocks, engine/inference.py) when the config is inside its
# envelope. Numerically equivalent (tested), but measured SLOWER than
# XLA's conv pipeline on v5e at R50 eval shapes — see PERF.md §2. Opt-in
# for Mosaic experimentation; default stays on the XLA path.
_C.TPU.FUSED_EVAL = False
# Long-axis decode cap as a multiple of the short side. The batch canvas is
# fixed at 2:1; content between 2:1 and this cap keeps its full long axis
# (windowed per view / per crop_u), content beyond it is center-cropped to
# the cap BEFORE the 3-position / random-crop protocols (no mainstream
# media exceeds it: anamorphic cinema tops out ~2.76:1). A one-time warning
# logs when the cap engages (data/datasets.py).
_C.TPU.DECODE_MAX_ASPECT = 4.0
# Checkpoint store: "msgpack" (single-file, master-only) or "orbax"
# (async sharded directories; every host participates — the production
# path for multi-host/large-model jobs).
_C.TPU.CHECKPOINT_BACKEND = "msgpack"


def get_cfg() -> CfgNode:
    """Return a fresh clone of the default config (reference: defaults.py:639-643)."""
    return _C.clone()


def assert_and_infer_cfg(cfg: CfgNode) -> CfgNode:
    """Config invariants (reference: defaults.py:616-636)."""
    if cfg.BN.NORM_TYPE == "sub_batchnorm":
        assert cfg.BN.NUM_SPLITS >= 1
    assert cfg.TRAIN.CHECKPOINT_TYPE in ("pytorch", "caffe2", "jax")
    assert cfg.TEST.CHECKPOINT_TYPE in ("pytorch", "caffe2", "jax")
    assert cfg.TPU.CHECKPOINT_BACKEND in ("msgpack", "orbax")
    assert cfg.NUM_GPUS >= 1
    assert cfg.TRAIN.BATCH_SIZE % cfg.NUM_GPUS == 0
    assert cfg.TEST.BATCH_SIZE % cfg.NUM_GPUS == 0
    # The reference asserts == 3 (defaults.py:627) yet its own TIRED/WHEEL
    # zoo ships NUM_SPATIAL_CROPS: 1 configs that its loader would reject;
    # 1-crop eval is well-defined (idx % 1 = 0 → left/top window, matching
    # reference kinetics.py:174-176 semantics), so accept both.
    assert cfg.TEST.NUM_SPATIAL_CROPS in (1, 3)
    assert cfg.SHARD_ID < cfg.NUM_SHARDS
    # int8 is a serving path: the quant collection is neither trained nor
    # checkpointed by the train loop (ops/conv.py::_Int8Conv1x1).
    assert not (cfg.TPU.INT8_EVAL and cfg.TRAIN.ENABLE), (
        "TPU.INT8_EVAL is eval/serving-only; set TRAIN.ENABLE False"
    )
    # two mutually exclusive serving engines: the fused fp engine bypasses
    # model.apply entirely, so combining them would calibrate int8 and then
    # silently serve fp (results labeled int8 that aren't)
    assert not (cfg.TPU.INT8_EVAL and cfg.TPU.FUSED_EVAL), (
        "TPU.INT8_EVAL and TPU.FUSED_EVAL are mutually exclusive serving "
        "paths; pick one"
    )
    # remat stage names must exist (stages are s2..s5); a typo here would
    # silently leave remat off and OOM at the documented batch sizes
    assert set(cfg.TPU.REMAT_STAGES) <= {2, 3, 4, 5}, (
        f"TPU.REMAT_STAGES {cfg.TPU.REMAT_STAGES} out of range: stages are "
        "2..5 (s2-s5)"
    )
    assert cfg.TPU.SPATIAL_SHARD >= 0, "TPU.SPATIAL_SHARD must be >= 0"
    assert cfg.MODEL.ARCH in cfg.MODEL.SINGLE_PATHWAY_ARCH + cfg.MODEL.MULTI_PATHWAY_ARCH
    return cfg
