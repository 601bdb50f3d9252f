"""phylo_utils_tpu_torch: the PyTorch/CUDA port of ``phylo_utils_tpu``.

Felsenstein-pruning log-likelihoods, gradients, fits, standard errors, ML
distances, NJ trees, model and profile mixtures, the codon site models
(M1a-M8, their LRTs and NEB/BEB site scans), model selection, sequence
simulation and the parametric bootstrap, topology sets and NNI/SPR search,
topology tests and branch supports, partitioned (multi-locus) engines,
ancestral reconstruction, branch and branch-site models and the molecular
clock on an NVIDIA GPU (or the CPU), held against the JAX package on the
same inputs. Every public name of the JAX package is exported here
(``tests/test_torch_names.py``); the CLI is ``python -m
phylo_utils_tpu_torch.cli``.
Importing the package loads no kernel: ``ops/_build.py`` compiles
``csrc/*.cu`` with ``nvcc`` at the first CUDA launch.
"""

__version__ = "0.1.0"

from phylo_utils_tpu_torch import models  # noqa: F401
from phylo_utils_tpu_torch.alphabets import (  # noqa: F401
    DNA,
    PROTEIN,
    Alphabet,
    encode_alignment,
    seq_to_partials,
)
from phylo_utils_tpu_torch.ancestral import (  # noqa: F401
    ancestral_posteriors,
    site_rate_posteriors,
)
from phylo_utils_tpu_torch.batched import (  # noqa: F401
    TopologySetEngine,
    nni_hill_climb,
    optimize_branch_lengths,
)
from phylo_utils_tpu_torch.branch_models import (  # noqa: F401
    BranchModelEngine,
    BranchSiteAEngine,
    branch_site_test,
    free_ratio_classes,
    mark_branches,
    mark_clade,
)
from phylo_utils_tpu_torch.clock import (  # noqa: F401
    ClockEngine,
    clock_test,
    node_height_errors,
)
from phylo_utils_tpu_torch.io import (  # noqa: F401
    CompressedAlignment,
    compress_patterns,
    load_compressed,
    parse_newick,
    read_alignment,
    read_fasta,
    read_phylip,
    write_newick,
)
from phylo_utils_tpu_torch.likelihood import (  # noqa: F401
    GammaMixture,
    LikelihoodEngine,
)
from phylo_utils_tpu_torch.markov import TransitionMatrix  # noqa: F401
from phylo_utils_tpu_torch.mixtures import (  # noqa: F401
    M1aEngine,
    M2aEngine,
    M7Engine,
    M8Engine,
    ModelMixtureEngine,
    beb_site_posteriors,
    beb_site_posteriors_m8,
    m1a_m2a_test,
    omega_posteriors,
    positive_selection_test,
)
from phylo_utils_tpu_torch.model_selection import compare_models  # noqa: F401
from phylo_utils_tpu_torch.nj import neighbor_joining  # noqa: F401
from phylo_utils_tpu_torch.optimize import (  # noqa: F401
    brent_minimize,
    fisher_covariance,
    fit,
    fit_multistart,
    golden_section,
    ml_distance_matrix,
    newton_branch_length,
    standard_errors,
)
from phylo_utils_tpu_torch.partition import (  # noqa: F401
    Partition,
    PartitionedEngine,
    StackedPartitionedEngine,
)
from phylo_utils_tpu_torch.profile_mixtures import (  # noqa: F401
    ProfileMixtureEngine,
    parse_nexus_models,
    profile_mixture_from_nexus,
)
from phylo_utils_tpu_torch.server import EngineServer  # noqa: F401
from phylo_utils_tpu_torch.simulate import (  # noqa: F401
    SequenceSimulator,
    simulate_alignment,
    simulate_branch_alignment,
    simulate_mixture_alignment,
)
from phylo_utils_tpu_torch.supports import (  # noqa: F401
    alrt_supports,
    bootstrap_tree_support,
)
from phylo_utils_tpu_torch.topology_tests import kh_test, sh_test  # noqa: F401
from phylo_utils_tpu_torch.trees import (  # noqa: F401
    Tree,
    compile_schedule,
    midpoint_root,
    nni_neighbors,
    random_tree,
    reroot,
    robinson_foulds,
    spr_neighbors,
)
