from .precision import serve_storage, serving_precision, tf32_matmuls
