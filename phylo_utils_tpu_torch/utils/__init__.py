"""Utilities of the PyTorch port: checkpoints, metrics, timing, tracing
and debug checks (``phylo_utils_tpu.utils``'s names; the JAX compile
cache has no counterpart: ``ops/_build.py`` keeps the built kernels)."""

from phylo_utils_tpu_torch.utils.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from phylo_utils_tpu_torch.utils.metrics import (  # noqa: F401
    MetricsLogger,
    Timer,
    enable_debug_checks,
    trace,
)
