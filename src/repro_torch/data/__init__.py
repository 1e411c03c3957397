"""Own numpy copies of ``repro.data.tokenizer`` and ``repro.data.synthetic``."""

from repro_torch.data.synthetic import SyntheticReactionDataset, make_reaction
from repro_torch.data.tokenizer import ATOMWISE_PATTERN, SmilesTokenizer

__all__ = ["SmilesTokenizer", "ATOMWISE_PATTERN", "SyntheticReactionDataset",
           "make_reaction"]
