"""The port's CLI on the CPU (``efficient_slowfast_tpu_torch.tools.run_net
--device cpu``): the multigrid SlowFast recipe of
configs/Kinetics/SLOWFAST_8x8_R50_stepwise_multigrid.yaml cut to a tiny
synthetic run (width 16, 16 frames, 32² crops, 12 classes, B 2 with a BN
base of 2, the solver's steps compressed to 4 epochs over 3 long-cycle
shapes), with the short cycle, split BN, precise BN, a checkpoint and a val
epoch every epoch, then the 30-view test from the last checkpoint."""

import os

import numpy as np
import pytest
import torch

from efficient_slowfast_tpu_torch.engine import test as test_engine
from efficient_slowfast_tpu_torch.engine import train as train_engine
from efficient_slowfast_tpu_torch.tools import run_net
from efficient_slowfast_tpu_torch.utils import multigrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(ROOT, "configs", "Kinetics",
                    "SLOWFAST_8x8_R50_stepwise_multigrid.yaml")


def argv(out_dir, *opts, flags=("--device", "cpu")):
    return list(flags) + ["--cfg", YAML,
            "TRAIN.DATASET", "synthetic", "TEST.DATASET", "synthetic",
            "TRAIN.BATCH_SIZE", "2", "MULTIGRID.BN_BASE_SIZE", "2",
            "SOLVER.STEPS", "[0, 2]", "SOLVER.MAX_EPOCH", "3",
            "RESNET.WIDTH_PER_GROUP", "16", "DATA.NUM_FRAMES", "16",
            "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_CROP_SIZE", "32",
            "DATA.CROP_SIZE", "32", "DATA.TRAIN_JITTER_SCALES", "[32, 40]",
            "MODEL.NUM_CLASSES", "12", "TPU.COMPUTE_DTYPE", "float32",
            "BN.NUM_BATCHES_PRECISE", "2", "DATA_LOADER.NUM_WORKERS", "2",
            "TEST.BATCH_SIZE", "16", "LOG_PERIOD", "100",
            "OUTPUT_DIR", str(out_dir)] + list(opts)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("cli")
    epochs, evals = [], []
    train_epoch, eval_epoch = train_engine.train_epoch, train_engine.eval_epoch

    def observed_train_epoch(cfg, state, step, pre, loader, meter, epoch,
                             **kw):
        sizes = []
        for batch in loader:
            sizes.append((len(batch["label"]), int(batch["_phase"])))
        epochs.append(dict(
            epoch=epoch, shape=(cfg.TRAIN.BATCH_SIZE, cfg.DATA.NUM_FRAMES,
                                cfg.DATA.TRAIN_CROP_SIZE),
            bn=type(state.model.s1.pathway0_stem.bn).__name__,
            splits=getattr(state.model.s1.pathway0_stem.bn, "num_splits", 1),
            norm=(cfg.BN.NORM_TYPE, cfg.BN.NUM_SPLITS),
            schedule=list(loader.batch_size_schedule), batches=sizes))
        return train_epoch(cfg, state, step, pre, loader, meter, epoch, **kw)

    def observed_eval_epoch(cfg, state, step, pre, loader, meter, epoch, **kw):
        evals.append(epoch)
        return eval_epoch(cfg, state, step, pre, loader, meter, epoch, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(train_engine, "train_epoch", observed_train_epoch)
    mp.setattr(train_engine, "eval_epoch", observed_eval_epoch)
    try:
        torch.manual_seed(0)
        out = run_net.main(argv(out_dir))
    finally:
        mp.undo()
    return dict(out=out, epochs=epochs, evals=evals, out_dir=out_dir)


def test_each_epoch_trains_the_schedules_shape(run):
    cfg = run_net.load_config(run_net.parse_args(argv(run["out_dir"])))
    schedule = multigrid.MultigridSchedule()
    cfg = schedule.init_multigrid(cfg)
    assert cfg.SOLVER.MAX_EPOCH == 4
    shapes = [multigrid.get_current_long_cycle_shape(schedule.schedule, e)
              for e in range(4)]
    assert len({tuple(s) for s in shapes}) == 3  # three long-cycle phases
    assert [e["epoch"] for e in run["epochs"]] == [0, 1, 2, 3]
    for e, (base_b, t, s) in zip(run["epochs"], shapes):
        b = base_b * 2
        assert e["shape"] == (b, t, s)
        k = b // 2  # clips over the BN base size
        if k > 1:
            assert e["norm"] == ("sub_batchnorm", k)
            assert (e["bn"], e["splits"]) == ("SubBatchNorm3d", k)
        else:
            assert e["norm"][0] == "batchnorm" and e["bn"] == "BatchNorm3d"
        # the short cycle: B times the reference's integer factors
        factors = [round((s / (f * 32)) ** 2) for f in (0.5, 0.5 ** 0.5)]
        assert e["schedule"] == [b * factors[0], b * factors[1], b]
        cycle = [(n, p) for p, n in enumerate(e["schedule"])]
        assert e["batches"][:3] == cycle
    assert run["evals"] == [0, 1, 2, 3]


def test_a_checkpoint_each_epoch_and_the_test_reads_the_last(run):
    ckpts = sorted(os.listdir(run["out_dir"] / "checkpoints"))
    assert ckpts == [f"checkpoint_epoch_{i:05d}.pyth" for i in range(1, 5)]
    meter = run["out"]["test"]
    assert meter.stats["_type"] == "test_final"
    np.testing.assert_allclose(meter.video_preds.sum(1), 30, rtol=1e-5)
    # test() given the last checkpoint by path scores every video alike
    last = run["out_dir"] / "checkpoints" / ckpts[-1]
    args = run_net.parse_args(argv(run["out_dir"], "TEST.CHECKPOINT_FILE_PATH",
                                   str(last), "TRAIN.ENABLE", "False"))
    assert args.device == "cpu"
    again = test_engine.test(run_net.load_config(args), device="cpu")
    np.testing.assert_array_equal(again.video_preds, meter.video_preds)
    state = run["out"]["train"]
    assert state.step == sum(len(e["batches"]) for e in run["epochs"])


def test_the_cli_raises_for_what_later_items_bring(tmp_path, monkeypatch):
    """Several processes (item 7) have come
    (tests/test_torch_port_distributed.py launches them): over the CPU
    they need DIST_BACKEND gloo, and the default nccl raises before any
    rendezvous (the demo, item 8, has come too:
    tests/test_torch_port_demo.py drives its branch); TensorBoard has come:
    MODEL_VIS alone writes every test clip's pathways (240 clips, 15
    batches of 16)."""
    with pytest.raises(ValueError, match="DIST_BACKEND nccl needs a CUDA"):
        run_net.main(argv(tmp_path, flags=["--device", "cpu",
                                           "--num_shards", "2"]))
    from efficient_slowfast_tpu_torch.engine import visualization

    videos = []

    class Writer:
        def __init__(self, cfg):
            pass

        def add_video(self, video, tag=None, global_step=None):
            videos.append((tag, global_step, video.shape[:2]))

        def close(self):
            videos.append("closed")

    monkeypatch.setattr(visualization, "TensorboardWriter", Writer)
    assert run_net.main(argv(
        tmp_path, "TENSORBOARD.ENABLE", "True", "TENSORBOARD.MODEL_VIS.ENABLE",
        "True", "TRAIN.ENABLE", "False", "TEST.ENABLE", "False")) == {}
    assert videos[-1] == "closed" and len(videos) == 31
    assert videos[:2] == [("Video Input Pathway 0", 0, (16, 4)),
                          ("Video Input Pathway 1", 0, (16, 16))]
