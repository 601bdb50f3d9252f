"""GTR (Tavare 1986) over A, C, G, T: six exchangeabilities
(AC, AG, AT, CG, CT, GT) and four frequencies."""
import torch

N_STATES = 4
SYMBOLS = ("A", "C", "G", "T")
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def build(rates: torch.Tensor, freqs: torch.Tensor):
    """(exchangeabilities (4, 4), frequencies (4,))."""
    sym = torch.zeros((4, 4), dtype=rates.dtype, device=rates.device)
    rows = torch.tensor([i for i, _ in _PAIRS], device=rates.device)
    cols = torch.tensor([j for _, j in _PAIRS], device=rates.device)
    sym = sym.index_put((rows, cols), rates).index_put((cols, rows), rates)
    return sym, freqs
