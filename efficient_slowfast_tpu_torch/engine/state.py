"""Train state, train and eval steps, inference forward (port of
``engine/state.py:29-245, 318-437``).

One train step is forward, loss, backward and the optimizer update, with
the BN running statistics updated in the forward and the metrics left on
the device: ``loss``, ``lr``, ``top1_err`` and ``top{k}_err`` are tensors,
and in one process nothing in a step waits for the card. Parameters and running
statistics stay float32 while the activations run in ``TPU.COMPUTE_DTYPE``.
Detection (AVA) has its own train step and forward, over padded boxes.

Across processes (``parallel/distributed.py``) a rank steps on its rows of
the global batch: the train state's model is wrapped in
``DistributedDataParallel`` (gradients averaged over the ranks), after a
checksum has shown every rank holds the same weights; BN reduces its
statistics across the ranks (``ops/norm.py``); and the step's loss, top-k
counts and ``num_valid`` are the global batch's on every rank, as the JAX
package's step reduces them inside its program.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.nn.parallel import DistributedDataParallel

from ..models.build import get_compute_dtype, resolve_device
from ..models.losses import get_elementwise_loss_func, get_loss_func
from ..models.optimizer import construct_optimizer, set_lr
from ..parallel import distributed
from ..utils import metrics as metrics_lib


@dataclass
class TrainState:
    """The model (parameters and BN running statistics), its optimizer
    (moments) and the count of steps taken. ``ddp`` is the model's
    ``DistributedDataParallel`` wrapper in a process group (the train step
    runs through it), else None; ``model`` stays the unwrapped module, so
    checkpoints and ``state_dict`` names are the reference's."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    ddp: Optional[DistributedDataParallel] = None

    @property
    def net(self) -> torch.nn.Module:
        """What the train step calls: the DDP wrapper, else the model."""
        return self.model if self.ddp is None else self.ddp


def step_generator(seed: int, counter: int, device,
                   stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one step's preprocess draws, seeded by
    (seed, counter) as the JAX package folds the step's counter into its
    key (``jax.random.fold_in``); ``stream`` > 0 gives another sequence of
    the same counter (the dropout's is 1)."""
    entropy = [seed, counter] + ([stream] if stream else [])
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _model_device(state) -> torch.device:
    return next(state.model.parameters()).device


def pathway_inputs(cfg, batch_size, dtype=torch.float32, device=None):
    """Zero example inputs [slow, fast] (or [frames]), channels-last
    (B, T, H, W, C), on ``device`` (the GPU by default)."""
    dev = resolve_device(device)
    t, s = cfg.DATA.NUM_FRAMES, cfg.DATA.CROP_SIZE
    c = cfg.DATA.INPUT_CHANNEL_NUM[0]
    shape = lambda frames: (batch_size, frames, s, s, c)  # noqa: E731
    if cfg.MODEL.ARCH in cfg.MODEL.MULTI_PATHWAY_ARCH:
        return [torch.zeros(shape(t // cfg.SLOWFAST.ALPHA), dtype=dtype,
                            device=dev),
                torch.zeros(shape(t), dtype=dtype, device=dev)]
    return [torch.zeros(shape(t), dtype=dtype, device=dev)]


def create_train_state(cfg, model: torch.nn.Module, device=None) -> TrainState:
    """The model on ``device`` (the GPU by default) with a fresh optimizer
    (``construct_optimizer``: zero moments) at step 0. The model keeps the
    weights it has, from ``build_model``'s init or a loaded state_dict.

    In a process group the ranks' weights and buffers are compared by
    checksum first (``verify_state_consistency``, which raises where they
    differ: DDP's constructor would overwrite them with rank 0's without a
    word), then the model is wrapped in DDP. Its buffers are not
    broadcast: BN's are equal on every rank by construction."""
    dev = resolve_device(device)
    model = model.to(dev)
    ddp = None
    if distributed.initialized():
        distributed.verify_state_consistency(model)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        ddp = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            broadcast_buffers=False)
    return TrainState(model=model, optimizer=construct_optimizer(cfg, model),
                      ddp=ddp)


def _device_inputs(cfg, model, inputs, labels):
    dev = next(model.parameters()).device
    dtype = get_compute_dtype(cfg)
    return ([x.to(dev, dtype, non_blocking=True) for x in inputs],
            labels.to(dev, non_blocking=True))


def make_train_step(cfg, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """step(state, inputs, labels, lr, generator) → metrics.

    Sets ``lr`` on every parameter group, runs the train-mode forward (the
    head's dropout drawing from ``generator``, required where
    ``MODEL.DROPOUT_RATE`` > 0), the loss, the backward and
    one update, and advances ``state.step``. With ``TPU.GRAD_ACCUM_STEPS``
    a > 1 the batch runs as a sequential microbatches, each forward updating
    the BN running statistics as a real step would, the gradients averaged
    over them (each microbatch's loss scaled by 1/a), one update; the loss
    is their mean and the top-k counts their sum. Across processes the
    microbatches but the last skip DDP's gradient reduction (``no_sync``),
    and microbatch i is every rank's i-th part; the metrics are the
    global batch's.
    """
    loss_fn = get_loss_func(cfg.MODEL.LOSS_FUNC)
    topk = cfg.TRAIN.TOPK
    accum = max(int(cfg.TPU.GRAD_ACCUM_STEPS), 1)
    classify = not cfg.DATA.MULTI_LABEL and not cfg.DETECTION.ENABLE

    def step(state: TrainState, inputs, labels, lr, generator=None):
        assert state.model is model and state.optimizer is optimizer, (
            "the train state holds another model or optimizer")
        if cfg.MODEL.DROPOUT_RATE > 0 and generator is None:
            raise ValueError("MODEL.DROPOUT_RATE > 0: the train step needs "
                             "a torch.Generator for the dropout masks")
        net = state.net
        inputs, labels = _device_inputs(cfg, model, inputs, labels)
        b = labels.shape[0]
        assert b % accum == 0, (
            f"batch {b} not divisible by TPU.GRAD_ACCUM_STEPS={accum}")
        m = b // accum
        set_lr(optimizer, lr)
        net.train()
        optimizer.zero_grad(set_to_none=True)
        loss_sum, counts = 0.0, [0.0, 0.0]
        for i in range(accum):
            part = slice(i * m, (i + 1) * m)
            with _sync_unless(state.ddp, i < accum - 1):
                preds = net([x[part] for x in inputs], generator=generator)
                loss = loss_fn(preds, labels[part])
                (loss / accum if accum > 1 else loss).backward()
            loss_sum = loss_sum + loss.detach()
            if classify:
                k1, kk = metrics_lib.topks_correct(preds.detach(),
                                                   labels[part], (1, topk))
                counts = [counts[0] + k1, counts[1] + kk]
        optimizer.step()
        state.step += 1
        dev = labels.device
        loss = loss_sum / accum if accum > 1 else loss_sum
        if distributed.world_size() > 1:
            loss, counts, b = _global_metrics(loss, counts, b)
        mets = {"loss": loss,
                "lr": torch.full((), lr, dtype=torch.float32, device=dev)}
        if classify:
            mets["top1_err"] = (1.0 - counts[0] / b) * 100.0
            mets[f"top{topk}_err"] = (1.0 - counts[1] / b) * 100.0
        return mets

    return step


def _sync_unless(ddp, skip: bool):
    """DDP's ``no_sync`` where ``skip`` (a microbatch but the last), else
    nothing."""
    return ddp.no_sync() if ddp is not None and skip else \
        contextlib.nullcontext()


def _global_metrics(loss, counts, b: int):
    """(the global batch's mean loss, its top-k counts, its size) from this
    rank's, with one all-reduce."""
    loss = loss.float()
    vec = torch.stack([loss * b] + [torch.as_tensor(c, dtype=torch.float32,
                                                    device=loss.device)
                                    for c in counts]
                      + [torch.full((), float(b), device=loss.device)])
    vec = distributed.all_reduce_sum(vec)
    return vec[0] / vec[-1], list(vec[1:-1]), vec[-1]


def make_eval_step(cfg, model: torch.nn.Module) -> Callable:
    """step(state, inputs, labels, valid=None) → metrics and post-activation
    preds, under ``inference_mode``.

    ``valid`` is the loader's {1, 0} padding mask: padded samples are left
    out of the error denominators, and ``num_valid`` is their count (the
    meter's weight). Across processes the counts are the global batch's.
    """
    topk = cfg.TRAIN.TOPK

    def step(state: TrainState, inputs, labels, valid=None):
        assert state.model is model, "the train state holds another model"
        inputs, labels = _device_inputs(cfg, model, inputs, labels)
        model.eval()
        with torch.inference_mode():
            preds = model(inputs)
            out = {"preds": preds}
            if not cfg.DATA.MULTI_LABEL and not cfg.DETECTION.ENABLE:
                c1, ck = metrics_lib.topks_correct_per_sample(
                    preds, labels, (1, topk))
                if valid is None:
                    k1, kk = c1.sum(), ck.sum()
                    num_valid = torch.full((), float(preds.shape[0]),
                                           device=preds.device)
                else:
                    v = valid.to(preds.device, torch.float32)
                    k1, kk = (c1 * v).sum(), (ck * v).sum()
                    num_valid = v.sum()
                if distributed.world_size() > 1:
                    k1, kk, num_valid = distributed.all_reduce_sum(
                        torch.stack([k1.float(), kk.float(),
                                     num_valid.float()]))
                n = torch.clamp(num_valid, min=1.0)
                out["top1_err"] = (1.0 - k1 / n) * 100.0
                out[f"top{topk}_err"] = (1.0 - kk / n) * 100.0
                out["num_valid"] = num_valid
        return out

    return step


def check_int8_calibrated(model: torch.nn.Module) -> None:
    """Refuse to serve a model whose int8 convs (``TPU.INT8_EVAL``) have no
    calibrated range: their zero scale would zero the network
    (``ops/conv.py:201-203`` there). ``engine/quantize.py`` calibrates."""
    from ..ops.conv import int8_convs, quant_is_calibrated

    if int8_convs(model) and not quant_is_calibrated(model):
        raise ValueError(
            "TPU.INT8_EVAL model is not calibrated: run "
            "engine.quantize.calibrate_int8 (or load a calibration) before "
            "serving it")


def make_forward(cfg, model: torch.nn.Module, device=None) -> Callable:
    """Eval forward: fn([slow, fast]) → scores, under ``inference_mode``.

    ``device`` defaults to the GPU (and raises where there is none); the
    model is moved there and put in eval mode, and inputs are moved there
    and cast to the compute dtype. ``cfg.TPU.FUSED_EVAL`` selects the fused
    serving engine (folded BN + the fused bottleneck kernel,
    engine/inference.py) when the config is inside its envelope; otherwise
    the module's own forward runs, its int8 convs (``TPU.INT8_EVAL``) on
    the int8 kernel, which needs a calibrated model.
    """
    dev = resolve_device(device)
    dtype = get_compute_dtype(cfg)
    model = model.to(dev).eval()
    fwd = model
    if cfg.TPU.FUSED_EVAL:
        # the fused engine never calls the module, so it cannot serve the
        # int8 path — refuse rather than silently serving fp as "int8"
        assert not cfg.TPU.INT8_EVAL, (
            "TPU.FUSED_EVAL and TPU.INT8_EVAL are mutually exclusive")
        from .inference import make_fused_eval_forward, supports

        if supports(cfg):
            fwd = make_fused_eval_forward(cfg, model)
    check_int8_calibrated(model)

    def forward(inputs):
        with torch.inference_mode():
            return fwd([x.to(dev, dtype, non_blocking=True) for x in inputs])

    return forward


def flatten_rois(boxes: torch.Tensor) -> torch.Tensor:
    """(B, MAX_BOXES, 4) boxes → (B·MAX_BOXES, 5) [batch index, x1, y1,
    x2, y2], the RoI head's layout."""
    b, m, _ = boxes.shape
    idx = torch.arange(b, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([idx.repeat_interleave(m)[:, None],
                      boxes.reshape(b * m, 4)], dim=1)


def make_detection_train_step(cfg, model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> Callable:
    """step(state, inputs, boxes, labels, mask, lr, generator) → metrics,
    the AVA train step.

    ``boxes`` (B, MAX, 4) in crop pixels, ``labels`` (B, MAX, classes)
    multi-hot, ``mask`` (B, MAX) {1, 0} for real and padded box slots. The
    RoI head's scores are post-activation in train mode too, so the loss
    is ``MODEL.LOSS_FUNC``'s elementwise form (``bce``; any other raises
    here), averaged over the classes and then over the real boxes (of the
    global batch, across processes: the count is reduced over the ranks,
    and each rank's loss scaled by the world size against DDP's mean). With
    ``TPU.GRAD_ACCUM_STEPS`` a > 1 the batch runs as a sequential
    microbatches, each adding the gradient of its unnormalised masked sum
    over the count of real boxes in the whole batch, so the update is the
    full batch's whatever the boxes' spread over the microbatches. The
    metrics are ``loss`` and ``lr``, on the card.
    """
    elem_loss_fn = get_elementwise_loss_func(cfg.MODEL.LOSS_FUNC)
    accum = max(int(cfg.TPU.GRAD_ACCUM_STEPS), 1)

    def step(state: TrainState, inputs, boxes, labels, mask, lr,
             generator=None):
        assert state.model is model and state.optimizer is optimizer, (
            "the train state holds another model or optimizer")
        if cfg.MODEL.DROPOUT_RATE > 0 and generator is None:
            raise ValueError("MODEL.DROPOUT_RATE > 0: the train step needs "
                             "a torch.Generator for the dropout masks")
        dev = next(model.parameters()).device
        dtype = get_compute_dtype(cfg)
        inputs = [x.to(dev, dtype, non_blocking=True) for x in inputs]
        boxes, labels, mask = (
            t.to(dev, torch.float32, non_blocking=True)
            for t in (boxes, labels, mask))
        b = mask.shape[0]
        assert b % accum == 0, (
            f"batch {b} not divisible by TPU.GRAD_ACCUM_STEPS={accum}")
        m = b // accum
        world = distributed.world_size()
        denom = torch.clamp(distributed.all_reduce_sum(mask.sum()), min=1.0)
        set_lr(optimizer, lr)
        state.net.train()
        optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for i in range(accum):
            part = slice(i * m, (i + 1) * m)
            with _sync_unless(state.ddp, i < accum - 1):
                preds = state.net([x[part] for x in inputs],
                                  flatten_rois(boxes[part]),
                                  generator=generator)
                per_box = elem_loss_fn(
                    preds, labels[part].reshape(-1, labels.shape[-1])).mean(-1)
                part_loss = (per_box * mask[part].reshape(-1)).sum() / denom
                (part_loss * world if world > 1 else part_loss).backward()
            loss = loss + part_loss.detach()
        if world > 1:
            loss = distributed.all_reduce_sum(loss)
        optimizer.step()
        state.step += 1
        return {"loss": loss,
                "lr": torch.full((), lr, dtype=torch.float32, device=dev)}

    return step


def make_detection_forward(cfg, model: torch.nn.Module,
                           device=None) -> Callable:
    """Eval forward: fn(inputs, boxes (B, MAX, 4)) → (B·MAX, classes)
    float32 scores, under ``inference_mode``, on ``device`` (the GPU by
    default, as ``make_forward``; an int8 model must be calibrated)."""
    dev = resolve_device(device)
    dtype = get_compute_dtype(cfg)
    model = model.to(dev).eval()
    check_int8_calibrated(model)

    def forward(inputs, boxes):
        with torch.inference_mode():
            rois = flatten_rois(boxes.to(dev, torch.float32,
                                         non_blocking=True))
            return model([x.to(dev, dtype, non_blocking=True)
                          for x in inputs], rois)

    return forward
