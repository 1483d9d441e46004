# Numpy-only synthetic data, a copy of the JAX package's (same seed, same
# arrays), and the prefetching loader that places batches on the device.
from .synthetic import (
    PhantomConfig,
    detection_batches,
    grid_targets,
    make_phantom_pair,
    phantom_batches,
    token_batches,
)
from .loader import FailingIterator, Prefetcher, shard_batch, to_device
