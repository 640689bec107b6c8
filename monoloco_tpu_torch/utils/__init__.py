from .precision import serving_precision
