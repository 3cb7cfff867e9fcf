from .node import CfgNode
from .defaults import get_cfg, assert_and_infer_cfg


def load_cfg(path: str | None, opts=None) -> CfgNode:
    """Default config merged with a YAML file (where given) and a CLI
    ``opts`` list."""
    cfg = get_cfg()
    if path:
        cfg.merge_from_file(path)
    if opts:
        cfg.merge_from_list(list(opts))
    return assert_and_infer_cfg(cfg)


__all__ = ["CfgNode", "get_cfg", "assert_and_infer_cfg", "load_cfg"]
