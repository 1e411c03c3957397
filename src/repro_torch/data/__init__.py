"""Own numpy copies of ``repro.data.tokenizer``, ``repro.data.synthetic`` and
``repro.data.pipeline``."""

from repro_torch.data.pipeline import batched_dataset, lm_batch, padded_batch
from repro_torch.data.synthetic import SyntheticReactionDataset, make_reaction
from repro_torch.data.tokenizer import ATOMWISE_PATTERN, SmilesTokenizer

__all__ = ["SmilesTokenizer", "ATOMWISE_PATTERN", "SyntheticReactionDataset",
           "make_reaction", "padded_batch", "lm_batch", "batched_dataset"]
