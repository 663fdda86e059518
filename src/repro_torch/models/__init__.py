"""Dense-family transformer model: parameters, layers, cache and serving
steps."""
