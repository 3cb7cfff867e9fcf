"""Export a checkpoint as a serving artifact (the port's counterpart of
``tools/export_serving.py``).

    python -m efficient_slowfast_tpu_torch.tools.export_serving \
        --cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml --out r50_serving \
        [--device cpu] [--max-boxes 32] \
        TEST.CHECKPOINT_FILE_PATH checkpoints/checkpoint_epoch_00196.pyth

Builds the model, loads its test checkpoint (``utils/checkpoint.py::
load_test_checkpoint``) and writes ``<out>.pt2`` with
``engine/export.py::export_serving``: the serving forward traced by
``torch.export``, weights baked in, the batch symbolic; int8 where
``TPU.INT8_EVAL`` is set and a calibration for this checkpoint persists
under OUTPUT_DIR (serve once with ``engine/test.py::test`` to make one).
It runs on the GPU unless ``--device`` names another torch device; a
serving host loads the file with ``engine/export.py::load_serving``, which
needs this package for the kernels' ops.
"""

from __future__ import annotations

import argparse

import torch

from ..config.parser import load_config_from
from ..engine.export import export_serving
from ..models import build_model
from ..models.build import resolve_device
from ..utils.checkpoint import load_test_checkpoint


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cfg", required=True, help="Path to config yaml.")
    ap.add_argument("--out", required=True,
                    help="Output artifact path (.pt2 appended if missing).")
    ap.add_argument("--device", default=None,
                    help="torch device to export on (e.g. cpu); the GPU "
                         "when not given.")
    ap.add_argument("--max-boxes", type=int, default=32,
                    help="Detection exports (DETECTION.ENABLE): the static "
                         "box slots a clip; the batch stays symbolic.")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                    help="KEY VALUE config override pairs.")
    args = ap.parse_args(argv)
    cfg = load_config_from(args.cfg, args.opts)
    device = resolve_device(args.device)
    torch.manual_seed(cfg.RNG_SEED)  # test()'s init where no checkpoint
    model = build_model(cfg, device)
    load_test_checkpoint(cfg, model)
    path = export_serving(cfg, model, args.out, max_boxes=args.max_boxes,
                          device=device)
    print(path)
    return path


if __name__ == "__main__":
    main()
