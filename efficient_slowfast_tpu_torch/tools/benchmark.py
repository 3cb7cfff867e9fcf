"""Data-loading benchmark CLI (the port's counterpart of
``tools/benchmark.py``; reference: SlowFast/tools/benchmark.py:15-25).

    python -m efficient_slowfast_tpu_torch.tools.benchmark \
        --cfg configs/TIRED/DUAL_TIRED_SLOWFAST_8x8_R50_112_GRAY.yaml KEY VAL ...

Times the train loader alone on the host (no device work); prints its
``json_stats`` lines.
"""

from __future__ import annotations

from ..config.parser import load_config, parse_args
from ..utils.benchmark import benchmark_data_loading
from ..utils.misc import launch_job


def main(argv=None) -> list:
    """Each epoch's seconds, from ``benchmark_data_loading``."""
    args = parse_args(argv)
    cfg = load_config(args)
    return launch_job(cfg, args.init_method, benchmark_data_loading)


if __name__ == "__main__":
    main()
