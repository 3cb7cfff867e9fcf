"""TensorBoard logging, plots and Grad-CAM (port of ``visualization/``)."""

from .gradcam import GradCAM, overlay_heatmap  # noqa: F401
from .tensorboard_vis import TensorboardWriter  # noqa: F401
