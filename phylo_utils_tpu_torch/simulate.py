"""Sequence simulation along a tree on the card (PyTorch port of
``phylo_utils_tpu.simulate``).

Root states are drawn from the equilibrium frequencies, then the tree is
walked in pre-order, each step sampling ALL sites of one node from the
gathered cumulative P(t) rows of its parent's states (``markov.sample_cdf``:
an inverse CDF). P and its float64 row cumsum are built once per (node,
unique rate): the discrete-gamma rates plus 0 for invariant sites, never
per (edge, site): a cumsum per step over the gathered (sites, S) rows
took 96% of an NVIDIA H100's time at 1000 taxa x 100,000 sites (PyTorch's
innermost-dim scan, ~0.63 ms a step), 6x the whole walk's time now. Leaf strings are built from a uint8 code table (3 bytes a
codon state) with one ``tobytes().decode()`` per leaf.

Randomness: the first argument is a ``torch.Generator`` (on the device the
simulation runs on) or an ``int`` that seeds one on ``device``; torch
cannot reproduce ``jax.random``'s streams, so one seed gives one alignment
here and another in the JAX package, equal in distribution.
``SequenceSimulator`` owns a generator and advances it per call, as the
JAX facade splits its key. Simulations run on the card (``device="cuda"``)
unless the caller passes ``device="cpu"`` or a CPU generator.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from phylo_utils_tpu_torch import io as pio
from phylo_utils_tpu_torch import trees as ptrees
from phylo_utils_tpu_torch.alphabets import get_alphabet
from phylo_utils_tpu_torch.markov import sample_cdf
from phylo_utils_tpu_torch.models.base import Model
from phylo_utils_tpu_torch.ops.gamma import discrete_gamma
from phylo_utils_tpu_torch.ops.pmatrix import transition_matrices

__all__ = [
    "simulate_states",
    "simulate_alignment",
    "simulate_mixture_alignment",
    "simulate_branch_alignment",
    "SequenceSimulator",
]

Seed = Union[int, torch.Generator]


def _generator(seed: Seed, device=None) -> torch.Generator:
    """``seed`` itself if it is a generator, else a new one seeded with it
    on ``device`` (default the card)."""
    if isinstance(seed, torch.Generator):
        if device is not None and torch.device(device) != seed.device:
            raise ValueError(f"generator on {seed.device}, device={device!r}")
        return seed
    device = torch.device(device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but "
                           "torch.cuda.is_available() is False")
    return torch.Generator(device=device).manual_seed(int(seed))


def _preorder_arrays(tree: ptrees.Tree) -> Tuple[np.ndarray, np.ndarray]:
    """Non-root nodes in parent-before-child order + their parents."""
    order = [n for n in tree.postorder()][::-1]  # root first
    nodes = np.asarray([n for n in order if n != tree.root], np.int64)
    return nodes, np.asarray(tree.parent[nodes], np.int64)


def _state_codes(model: Model) -> np.ndarray:
    """(S, width) uint8 output characters per state: 3 bytes a codon state
    (any genetic code, ``"codon"`` or ``"codon:<code>"``), else 1."""
    name = str(getattr(model.alphabet, "name", model.alphabet))
    if name.startswith("codon"):
        from phylo_utils_tpu_torch.models.codon import code_tables

        states = code_tables(name.partition(":")[2] or "standard")[0]
    else:
        states = get_alphabet(model.alphabet).states
    return np.frombuffer("".join(states).encode("ascii"), np.uint8).reshape(
        len(states), -1)


def _state_chars(model: Model) -> np.ndarray:
    """(S,) per-state output strings (a codon state's are 3 characters): the
    rows of ``_state_codes`` as text."""
    return np.asarray([row.tobytes().decode("ascii")
                       for row in _state_codes(model)])


def _leaf_strings(tree: ptrees.Tree, chars: np.ndarray) -> Dict[str, str]:
    """name -> sequence of the (n_leaves, n_sites, width) uint8 chars."""
    return {name: chars[i].tobytes().decode("ascii")
            for i, name in enumerate(tree.leaf_names)}


def _leaf_chars(model: Model, tree: ptrees.Tree,
                states: torch.Tensor) -> np.ndarray:
    """(n_leaves, n_sites, width) uint8 characters of the leaves' rows of
    ``states``."""
    return _state_codes(model)[
        states[: tree.n_leaves].to("cpu", torch.int64).numpy()]


def _walk(gen: torch.Generator, tree: ptrees.Tree, p: torch.Tensor,
          freqs: torch.Tensor, n_sites: int, site_p=None) -> torch.Tensor:
    """(n_nodes, n_sites) states: the root drawn from ``freqs``, each other
    node from the rows ``p[node][site_p, parent_state]`` (``p``: (n_nodes,
    R, S, S) with ``site_p`` (n_sites,) indexing R, or (n_nodes, S, S) with
    ``site_p`` None)."""
    cdf = torch.cumsum(p.to(torch.float64), dim=-1)
    nodes, parents = _preorder_arrays(tree)
    states = torch.empty((tree.n_nodes, n_sites), dtype=torch.long,
                         device=p.device)
    states[tree.root] = sample_cdf(gen, torch.cumsum(
        freqs.to(torch.float64), 0).expand(n_sites, -1))
    for node, parent in zip(nodes.tolist(), parents.tolist()):
        rows = (cdf[node][states[parent]] if site_p is None
                else cdf[node][site_p, states[parent]])
        states[node] = sample_cdf(gen, rows)
    return states


def simulate_states(
    seed: Seed,
    tree: ptrees.Tree,
    model: Model,
    n_sites: int,
    params: Optional[Mapping] = None,
    ncat: int = 1,
    pinv: float = 0.0,
    median: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sample ancestral + leaf states.

    Returns ``(states, site_rates)`` on the generator's device:
    ``states`` (n_nodes, n_sites) int64 and ``site_rates`` (n_sites,)
    float64, the per-site rate multipliers used (0.0 for invariant sites
    drawn by ``pinv``). ``params`` holds the model's parameters and,
    with ``ncat > 1``, ``alpha`` (default 0.5).
    """
    gen = _generator(seed, device)
    dev, f64 = gen.device, torch.float64
    params = dict(params) if params else {}
    # mixture parameters ride in `params` but are NOT model-builder kwargs
    alpha = params.pop("alpha", 0.5)
    eig = model.eigen(params, dtype=f64, device=dev)

    if ncat > 1:
        rates = discrete_gamma(
            torch.as_tensor(alpha, dtype=f64).detach().cpu(), ncat, median
        ).to(dev)
        site_r = torch.randint(0, ncat, (n_sites,), generator=gen,
                               device=dev)
    else:
        rates = torch.ones((1,), dtype=f64, device=dev)
        site_r = torch.zeros((n_sites,), dtype=torch.long, device=dev)
    if pinv > 0:
        inv = torch.rand((n_sites,), generator=gen, dtype=f64,
                         device=dev) < pinv
        site_r = torch.where(inv, rates.shape[0], site_r)
    # one P per (node, unique rate): the rates, and 0 for invariant sites
    uniq = torch.cat([rates, torch.zeros((1,), dtype=f64, device=dev)])
    site_rates = uniq[site_r]

    lengths = torch.as_tensor(tree.lengths, dtype=f64, device=dev)
    p = transition_matrices(eig, lengths[:, None] * uniq[None, :])
    return _walk(gen, tree, p, eig.freqs, n_sites, site_r), site_rates


def simulate_alignment(
    seed: Seed,
    tree: Union[ptrees.Tree, str],
    model: Model,
    n_sites: int,
    params: Optional[Mapping] = None,
    ncat: int = 1,
    pinv: float = 0.0,
    median: bool = False,
    device=None,
) -> Dict[str, str]:
    """Simulate a name->sequence dict at the leaves (reference output
    shape; a codon model writes 3 characters a site)."""
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    states, _ = simulate_states(seed, tree, model, n_sites, params, ncat,
                                pinv, median, device)
    return _leaf_strings(tree, _leaf_chars(model, tree, states))


def simulate_mixture_alignment(
    seed: Seed,
    tree: Union[ptrees.Tree, str],
    model: Model,
    n_sites: int,
    mixture,
    weights=None,
    shared: Optional[Mapping] = None,
    device=None,
) -> Tuple[Dict[str, str], np.ndarray]:
    """Simulate under a MODEL MIXTURE: each site draws its class iid.

    ``mixture``: list of per-class model-parameter dicts (e.g.
    ``[{"omega": 0.1}, {"omega": 1.0}, {"omega": 4.0}]``, M2a-style data);
    ``weights``: class probabilities (uniform default); ``shared``:
    parameters common to all classes (kappa, freqs). Returns
    ``(alignment, site_classes)`` so that tests know each site's class.
    A codon site is 3 characters wide under every genetic code (the JAX
    package cuts ``"codon:<code>"`` sites one character wide: ROADMAP C).
    """
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    gen = _generator(seed, device)
    k = len(mixture)
    w = torch.as_tensor(np.full(k, 1.0 / k) if weights is None else
                        np.asarray(weights, np.float64), dtype=torch.float64,
                        device=gen.device)
    site_classes = sample_cdf(gen, torch.cumsum(w, 0).expand(n_sites, -1)
                              ).cpu().numpy()
    out = np.empty((tree.n_leaves, n_sites, _state_codes(model).shape[1]),
                   np.uint8)
    for c in range(k):
        cols = np.flatnonzero(site_classes == c)
        if cols.size:
            states, _ = simulate_states(
                gen, tree, model, cols.size,
                params={**dict(shared or {}), **mixture[c]})
            out[:, cols] = _leaf_chars(model, tree, states)
    return _leaf_strings(tree, out), site_classes


class SequenceSimulator:
    """OO facade mirroring the reference's ``SequenceSimulator`` API."""

    def __init__(self, tree, model: Model, params=None, ncat: int = 1,
                 pinv: float = 0.0, median: bool = False, seed: int = 0,
                 device="cuda"):
        self.tree = pio.parse_newick(tree) if isinstance(tree, str) else tree
        self.model = model
        self.params = params
        self.ncat = ncat
        self.pinv = pinv
        self.median = median
        self._gen = _generator(seed, device)

    def simulate(self, n_sites: int) -> Dict[str, str]:
        """A new alignment of ``n_sites``; the generator advances."""
        return simulate_alignment(
            self._gen, self.tree, self.model, n_sites, self.params,
            self.ncat, self.pinv, self.median,
        )


def simulate_branch_alignment(
    seed: Seed,
    tree: Union[ptrees.Tree, str],
    model: Model,
    branch_classes,
    class_params,
    n_sites: int,
    shared: Optional[Mapping] = None,
    device=None,
) -> Dict[str, str]:
    """Simulate under PER-EDGE-CLASS models (the BranchModelEngine dual).

    ``branch_classes``: (n_nodes,) class of each node's parent edge;
    ``class_params``: one model-parameter dict per class; ``shared``:
    parameters common to all classes. Single rate category. The root draws
    from the ROOT class's stationary distribution.
    """
    if isinstance(tree, str):
        tree = pio.parse_newick(tree)
    cls = np.asarray(branch_classes, np.int64)
    if cls.shape != (tree.n_nodes,):
        raise ValueError("branch_classes must have one entry per node")
    n_classes = int(cls.max()) + 1
    if len(class_params) < n_classes:
        raise ValueError("class_params shorter than the class id range")
    gen = _generator(seed, device)
    dev = gen.device
    eigs = [model.eigen({**dict(shared or {}), **class_params[c]},
                        dtype=torch.float64, device=dev)
            for c in range(n_classes)]
    lengths = torch.as_tensor(tree.lengths, dtype=torch.float64, device=dev)
    p_by_class = torch.stack([transition_matrices(e, lengths) for e in eigs])
    p = p_by_class[torch.as_tensor(cls, device=dev),
                   torch.arange(tree.n_nodes, device=dev)]  # (n_nodes, S, S)
    states = _walk(gen, tree, p, eigs[int(cls[tree.root])].freqs, n_sites)
    return _leaf_strings(tree, _leaf_chars(model, tree, states))
