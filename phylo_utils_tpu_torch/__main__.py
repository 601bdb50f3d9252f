"""``python -m phylo_utils_tpu_torch <subcommand> ...``: the port's CLI
(``phylo_utils_tpu_torch.cli``)."""
import sys

from phylo_utils_tpu_torch.cli import main

sys.exit(main())
