"""The system under test, the PyTorch and CUDA port, built from a
configuration file: the only module of the harness that imports it."""

from __future__ import annotations


def port_cfg(config: dict):
    """The port's config: its defaults, the configuration's yaml values,
    then its overrides."""
    from efficient_slowfast_tpu_torch.config import (CfgNode,
                                                     assert_and_infer_cfg,
                                                     get_cfg)

    cfg = get_cfg()
    cfg.merge_from_other_cfg(CfgNode(config["cfg"]))
    opts = []
    for key, value in config.get("overrides", {}).items():
        opts += [key, value]
    cfg.merge_from_list(opts)
    return assert_and_infer_cfg(cfg)


def lookup(cfg, key: str):
    for part in key.split("."):
        cfg = cfg[part]
    return cfg


def model(cfg, state_dict: dict, device):
    """The port's model on ``device`` holding ``state_dict``."""
    from efficient_slowfast_tpu_torch.models import build_model

    net = build_model(cfg, device=device)
    net.load_state_dict(state_dict, strict=True)
    return net


def forward(cfg, net, device):
    """The port's serving entry (``make_forward``: the fused engine where
    ``TPU.FUSED_EVAL`` selects it, else the module)."""
    from efficient_slowfast_tpu_torch.engine.state import make_forward

    return make_forward(cfg, net, device=device)


def train_step(cfg, net, device):
    """(train state, step) of the port's training entry."""
    from efficient_slowfast_tpu_torch.engine.state import (create_train_state,
                                                           make_train_step)

    state = create_train_state(cfg, net, device=device)
    return state, make_train_step(cfg, net, state.optimizer)
