"""Grad-CAM of one video (the port's counterpart of
``tools/gradcam_video.py``; reference: wdf_visualization/gradcam_video.py).

    python -m efficient_slowfast_tpu_torch.tools.gradcam_video \
        --cfg configs/Kinetics/SLOWFAST_8x8_R50.yaml --video clip.mp4 \
        --target-layer s5 --gif [--device cpu] \
        TEST.CHECKPOINT_FILE_PATH checkpoints/checkpoint_epoch_00196.pyth

Loads the config and checkpoint, runs Grad-CAM on the video's first clip
at the target layer, writes one overlay mp4 per pathway (and a GIF with
``--gif``) and prints the top five classes. ``--print-flops`` prints the
per-layer FLOPs table instead. Runs on the GPU unless ``--device`` names
another torch device.
"""

from __future__ import annotations

import argparse

from ..config.parser import load_config_from


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cfg", required=True, help="Path to config yaml.")
    ap.add_argument("--video", required=True, help="Video file to explain.")
    ap.add_argument("--target-layer", default="s5",
                    help="A module of the model (s1..s5, s1_fuse..s4_fuse "
                         "for the ResNet SlowFast and CMDA; s1..s4 and "
                         "s1_fuse..s3_fuse for the efficient backbones, "
                         "whose last stage is s4), by the port's name "
                         "(s4.pathway1_res3) or the JAX package's "
                         "slash-joined path (s4/pathway1_res3).")
    ap.add_argument("--target-class", type=int, default=None,
                    help="Class index to explain (default: the argmax).")
    ap.add_argument("--out-dir", default=None,
                    help="Output directory (default: cfg.OUTPUT_DIR).")
    ap.add_argument("--gif", action="store_true",
                    help="Also write a GIF per pathway.")
    ap.add_argument("--print-flops", action="store_true",
                    help="Print the per-layer FLOPs table and exit.")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU, required).")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=None,
                    help="KEY VALUE config override pairs.")
    args = ap.parse_args(argv)
    cfg = load_config_from(args.cfg, args.opts)

    if args.print_flops:
        from ..engine.state import pathway_inputs
        from ..models import build_model
        from ..models.build import get_compute_dtype, resolve_device
        from ..utils.misc import flops_per_layer_table

        dev = resolve_device(args.device)
        table = flops_per_layer_table(build_model(cfg, dev), pathway_inputs(
            cfg, 1, get_compute_dtype(cfg), dev))
        print(table)
        return table

    from ..visualization.video_cam import gradcam_video

    result = gradcam_video(cfg, args.video, args.target_layer,
                           target_class=args.target_class,
                           out_dir=args.out_dir, write_gif=args.gif,
                           device=args.device)
    preds = result["predictions"][0]
    labels = None
    if cfg.DEMO.LABEL_FILE_PATH:
        from ..utils.misc import load_demo_labels

        labels = load_demo_labels(cfg.DEMO.LABEL_FILE_PATH)
    for k in preds.argsort()[::-1][:5]:
        name = labels[k] if labels and k < len(labels) else str(k)
        print(f"{name}: {preds[k]:.4f}")
    for p in result["outputs"]:
        print(p)
    return result


if __name__ == "__main__":
    main()
