"""Figure outputs of predict (front, bird, multi, keypoints): host copies of
the JAX package's drawing code. Importing this package imports neither
matplotlib nor Pillow; the drawing functions import matplotlib when called."""

from .printer import Printer, draw_orientation, draw_uncertainty, social_distance_colors
from .pifpaf_show import KeypointPainter, image_canvas, get_pifpaf_outputs
