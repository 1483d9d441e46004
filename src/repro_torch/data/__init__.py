# Numpy-only synthetic data, a copy of the JAX package's (same seed, same arrays).
from .synthetic import (
    PhantomConfig,
    detection_batches,
    grid_targets,
    make_phantom_pair,
    phantom_batches,
    token_batches,
)
