"""Train, test, demo, then visualize (the port's counterpart of
``tools/run_net.py``; reference: SlowFast/tools/run_net.py:14-37).

    python -m efficient_slowfast_tpu_torch.tools.run_net \
        --cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml [--device cpu] KEY VAL ...
    python -m efficient_slowfast_tpu_torch.tools.run_net \
        --cfg demo/Kinetics/SLOWFAST_8x8_R50.yaml DEMO.DATA_SOURCE clip.mp4

Runs on the GPU unless ``--device`` names another torch device; with no
GPU and no ``--device`` it raises rather than run on the CPU.

A job of several processes, one per GPU (``utils/misc.py::launch_job``):
``NUM_GPUS g`` spawns g processes on a machine, ranks ``cuda:0`` to
``cuda:g-1``; over N machines each runs the same command with
``--num_shards N --shard_id i --init_method tcp://<machine 0>:<port>``.
The ranks talk over ``DIST_BACKEND`` (``nccl``; ``gloo`` for
``--device cpu``). The config's batch sizes are the global batch's.
"""

from __future__ import annotations

from ..config.parser import load_config, parse_args
from ..engine.demo import demo
from ..engine.test import test
from ..engine.train import train
from ..engine.visualization import visualize
from ..models.build import resolve_device
from ..utils.misc import launch_job


def run_stages(cfg, device) -> dict:
    """Train, test, demo and visualize, each where the config enables it,
    in this process (one rank of the job)."""
    out = {}
    if cfg.TRAIN.ENABLE:
        out["train"] = train(cfg, device=device)
    if cfg.TEST.ENABLE:
        out["test"] = test(cfg, device=device)
    if cfg.DEMO.ENABLE:
        out["demo"] = demo(cfg, device=device)
    if cfg.TENSORBOARD.ENABLE and cfg.TENSORBOARD.MODEL_VIS.ENABLE:
        visualize(cfg, device=device)
    return out


def main(argv=None) -> dict:
    """Train (``TRAIN.ENABLE``), test (``TEST.ENABLE``), run the demo
    (``DEMO.ENABLE``), then write the test inputs to TensorBoard
    (``TENSORBOARD.MODEL_VIS``) for the config of ``argv`` (``sys.argv`` by
    default), as one job of ``NUM_SHARDS x NUM_GPUS`` processes
    (``launch_job``); returns {"train": the final train state, "test": the
    finished TestMeter, "demo": the demo's window entries}, each where it
    ran, or {} where the processes were spawned."""
    args = parse_args(argv)
    cfg = load_config(args)
    device = resolve_device(args.device)
    return launch_job(cfg, args.init_method, run_stages, device) or {}


if __name__ == "__main__":
    main()
