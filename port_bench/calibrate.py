"""The readings that the limits of ``correct`` are set from, many seeds of
one cell in one process:

    python port_bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--controls 3]

For each seed it runs the cell as ``run.py`` does (set-up, a short window,
the program freed, the check) and prints the compared numbers of that
sound run; for the first ``--controls`` seeds it also prints the control's
(the reference computed in float8 in the program's place) and, in a
training cell, a planted fault's (each step on half of its batch). One
JSON object a line, on standard output. Needs the card.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def look(d) -> dict:
    """A training run's detail: each step's loss on both sides, the leaves
    left out, and the widest gaps by leaf (over the larger of the leaf's
    reference norm and the median leaf's) with those leaves."""
    from port_bench import compare

    got, ref = d.compared
    leaves = compare.kept_leaves(ref["grad"])
    out = {"loss": got["loss"], "reference_loss": ref["loss"],
           "loss1_gap": compare.loss_gap(got["loss"][:1], ref["loss"][:1]),
           "left_out": sorted(set(ref["grad"]) - set(leaves))}
    for key in ("grad", "change"):
        gaps = compare.leaf_gaps(got[key], ref[key], leaves)
        out[f"{key}_worst_gap"] = max(gaps.values())
        out[key] = sorted(((g, n, got[key][n], ref[key][n])
                           for n, g in gaps.items()), reverse=True)[:4]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--no-tf32", action="store_true",
                   help="cuDNN's convolutions without TF32 in the program "
                        "too (a look at a float32 program, not a sound run)")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="an override of the configuration, for a look at "
                        "the program off the configuration (not a sound run)")
    args = p.parse_args(argv)
    import torch

    from port_bench import manifest, window

    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell, mix, config = manifest.cell_files(args.workload)
    for item in args.set:
        key, value = item.split("=", 1)
        config["overrides"][key] = value
    cls = manifest.driver_class(mix["kind"])
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        d = cls(cell, mix, config, seed, torch.device("cuda"))
        d.setup()
        window.run(d, args.seconds)
        d.release()
        rows = {"program": d.check()}
        detail = look(d) if hasattr(d, "compared") else None
        if k < args.controls:
            rows["control"] = d.control()
            if hasattr(d, "half_batch"):
                rows["half_batch"] = d.half_batch()
        for kind, checks in rows.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind,
                              "set": args.set + ["no-tf32"] * args.no_tf32, "numbers": {
                                  n: v for n, v, _ in checks},
                              "seconds": time.time() - t0}), flush=True)
        if detail is not None:
            print(json.dumps(dict(seed=seed, kind="look", **detail)),
                  flush=True)
        del d
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
