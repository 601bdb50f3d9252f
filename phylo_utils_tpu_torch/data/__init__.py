"""Empirical substitution-model data (exchangeabilities + frequencies).

Reference capability: phylo_utils/data.py ships LG and WAG empirical rate
matrices and equilibrium frequencies as array literals (SURVEY.md §2 [HIGH]).

State order is the PAML convention A R N D C Q E G H I L K M F P S T W Y V
(matching :data:`phylo_utils_tpu_torch.alphabets.PROTEIN`). Host-side numpy,
copied unchanged from ``phylo_utils_tpu.data``.
"""
from phylo_utils_tpu_torch.data.lg import LG_RATES, LG_FREQS  # noqa: F401
from phylo_utils_tpu_torch.data.wag import WAG_RATES, WAG_FREQS  # noqa: F401
