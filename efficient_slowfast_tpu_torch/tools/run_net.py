"""Train, test, demo, then visualize (the port's counterpart of
``tools/run_net.py``; reference: SlowFast/tools/run_net.py:14-37).

    python -m efficient_slowfast_tpu_torch.tools.run_net \
        --cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml [--device cpu] KEY VAL ...
    python -m efficient_slowfast_tpu_torch.tools.run_net \
        --cfg demo/Kinetics/SLOWFAST_8x8_R50.yaml DEMO.DATA_SOURCE clip.mp4

Runs on the GPU unless ``--device`` names another torch device; with no
GPU and no ``--device`` it raises rather than run on the CPU.
"""

from __future__ import annotations

import functools

from ..config.parser import load_config, parse_args
from ..engine.demo import demo
from ..engine.test import test
from ..engine.train import train
from ..engine.visualization import visualize
from ..models.build import resolve_device
from ..utils.misc import launch_job


def main(argv=None) -> dict:
    """Train (``TRAIN.ENABLE``), test (``TEST.ENABLE``), run the demo
    (``DEMO.ENABLE``), then write the test inputs to TensorBoard
    (``TENSORBOARD.MODEL_VIS``) for the config of ``argv`` (``sys.argv`` by
    default); returns {"train": the final train state, "test": the
    finished TestMeter, "demo": the demo's window entries}, each where it
    ran."""
    args = parse_args(argv)
    cfg = load_config(args)
    device = resolve_device(args.device)
    out = {}
    if cfg.TRAIN.ENABLE:
        out["train"] = launch_job(cfg, args.init_method,
                                  functools.partial(train, device=device))
    if cfg.TEST.ENABLE:
        out["test"] = launch_job(cfg, args.init_method,
                                 functools.partial(test, device=device))
    if cfg.DEMO.ENABLE:
        out["demo"] = launch_job(cfg, args.init_method,
                                 functools.partial(demo, device=device))
    if cfg.TENSORBOARD.ENABLE and cfg.TENSORBOARD.MODEL_VIS.ENABLE:
        launch_job(cfg, args.init_method,
                   functools.partial(visualize, device=device))
    return out


if __name__ == "__main__":
    main()
