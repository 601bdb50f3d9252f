"""Site sharding over devices and processes (PyTorch port of
``phylo_utils_tpu.parallel``)."""
from phylo_utils_tpu_torch.parallel.sharding import (  # noqa: F401
    SiteSharding,
    distributed_init,
    make_mesh,
)
