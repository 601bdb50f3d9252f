"""The M7-vs-M8 positive-selection test fitted in the PyTorch port alone
(``tests/test_mixtures.py``'s recovery case, at 150 codons): half the sites
simulated by the port under purifying selection (omega 0.1), half under
positive selection (omega 4), kappa 2, on a 6-taxon tree. M8's extra class
must take omega > 1, the LRT reject M7, and the NEB and BEB scans rank the
positive half above the purifying one. Kept apart from the parity file so
that the test workers run the two side by side; one intra-op thread.
"""

from phylo_utils_tpu_torch import mixtures as tmix
from phylo_utils_tpu_torch import models as tmodels
from phylo_utils_tpu_torch.io import encode_codon_alignment
from phylo_utils_tpu_torch.models.codon import empirical_codon_frequencies
from phylo_utils_tpu_torch.optimize import fit
from phylo_utils_tpu_torch.simulate import simulate_mixture_alignment
from phylo_utils_tpu_torch.trees import random_tree

from torch_threads import one_thread  # noqa: F401


def test_m7_m8_recovery_in_the_port():
    tree = random_tree(6, seed=1, mean_brlen=0.2)
    aln, classes = simulate_mixture_alignment(
        7, tree, tmodels.GY94, 150, [{"omega": 0.1}, {"omega": 4.0}],
        shared={"kappa": 2.0}, device="cpu")
    positive = classes == 1
    ca = encode_codon_alignment(aln)
    # codeml's convention, as the CLI's site-test: F3x4 held, kappa free
    params0 = {"shared": {"freqs": empirical_codon_frequencies(aln, "f3x4")}}
    free7 = ("branch_lengths", "shared.kappa", "beta_p", "beta_q")
    m7 = tmix.M7Engine(tree, ca, ncat=4, device="cpu")
    res7 = fit(m7, params0=params0, free=free7, max_steps=30, patience=8)
    m8 = tmix.M8Engine(tree, ca, ncat=4, device="cpu")
    res8 = fit(m8, params0=params0, free=free7 + ("p0", "omega_delta"),
               max_steps=30, patience=8)
    assert res8.loglik > res7.loglik - 1e-6
    assert tmix.positive_selection_test(res7.loglik,
                                        res8.loglik)["pvalue"] < 0.01
    assert 1.0 + float(res8.params["omega_delta"]) > 1.5
    assert 0.2 < float(res8.params["p0"]) < 0.95
    _, gam = tmix.omega_posteriors(m8, res8.params)
    assert gam.shape == (150, 5)
    assert gam[positive, -1].mean() > gam[~positive, -1].mean() + 0.2
    p_pos, mean_w = tmix.beb_site_posteriors_m8(m8, res8.params, d=4,
                                                n_fine=8)
    assert p_pos[positive].mean() > p_pos[~positive].mean() + 0.2
    assert mean_w[positive].mean() > mean_w[~positive].mean() + 0.5
