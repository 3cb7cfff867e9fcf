"""Plot utilities (port of ``visualization/utils.py``; reference:
slowfast/visualization/utils.py:15-165).

The confusion matrix is numpy's own (the card's machine has no sklearn),
equal to sklearn's ``confusion_matrix(..., normalize=...)`` with NaN as 0;
matplotlib is imported at call time, on the Agg backend.
"""

from __future__ import annotations

import numpy as np


def get_confusion_matrix(preds: np.ndarray, labels: np.ndarray,
                         num_classes: int, normalize: str = "true"):
    """Confusion matrix (true class by row, predicted by column) of the
    score rows ``preds`` (or predicted classes) against ``labels``,
    normalized over each true class ("true"), predicted class ("pred"),
    everything ("all") or not at all (None); empty rows and columns are 0.
    Labels and predictions outside [0, num_classes) are left out."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    if preds.ndim == 2:
        preds = preds.argmax(-1)
    keep = ((labels >= 0) & (labels < num_classes)
            & (preds >= 0) & (preds < num_classes))
    cm = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(cm, (labels[keep].astype(np.int64),
                   preds[keep].astype(np.int64)), 1)
    with np.errstate(all="ignore"):
        if normalize == "true":
            cm = cm / cm.sum(axis=1, keepdims=True)
        elif normalize == "pred":
            cm = cm / cm.sum(axis=0, keepdims=True)
        elif normalize == "all":
            cm = cm / cm.sum()
    return np.nan_to_num(cm)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_confusion_matrix(cmtx, num_classes, class_names=None, figsize=None):
    """A matplotlib figure of the confusion matrix ``cmtx``."""
    plt = _pyplot()
    if class_names is None or not isinstance(class_names, list):
        class_names = [str(i) for i in range(num_classes)]
    figure = plt.figure(figsize=figsize)
    plt.imshow(cmtx, interpolation="nearest", cmap=plt.cm.Blues)
    plt.title("Confusion matrix")
    plt.colorbar()
    tick_marks = np.arange(len(class_names))
    plt.xticks(tick_marks, class_names, rotation=45)
    plt.yticks(tick_marks, class_names)
    threshold = cmtx.max() / 2.0 if cmtx.size else 0.5
    for i in range(cmtx.shape[0]):
        for j in range(cmtx.shape[1]):
            color = "white" if cmtx[i, j] > threshold else "black"
            plt.text(j, i, format(cmtx[i, j], ".2f") if cmtx[i, j] != 0 else ".",
                     horizontalalignment="center", color=color)
    plt.tight_layout()
    plt.ylabel("True label")
    plt.xlabel("Predicted label")
    return figure


def plot_topk_histogram(class_idx, histogram, topk=10, class_names=None,
                        figsize=None):
    """A bar chart of the ``topk`` largest entries of ``histogram`` (a row
    of the confusion matrix: what the true class ``class_idx`` was
    predicted as)."""
    plt = _pyplot()
    ranks = np.argsort(-np.asarray(histogram))[:topk]
    if class_names is None or not isinstance(class_names, list):
        class_names = [str(i) for i in range(len(histogram))]
    fig = plt.figure(figsize=figsize)
    plt.bar(range(len(ranks)), [histogram[r] for r in ranks])
    plt.xticks(range(len(ranks)), [class_names[r] for r in ranks], rotation=45)
    name = (class_names[class_idx] if class_idx < len(class_names)
            else str(class_idx))
    plt.title(f"Top predictions for true class {name}")
    plt.tight_layout()
    return fig
