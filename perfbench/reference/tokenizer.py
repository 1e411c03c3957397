"""Atomwise SMILES tokenizer (Schwaller et al., 2019): a frozen copy kept
with the benchmark, so the yardstick does not move when the program's own
tokenizer changes.

ids: pad 0, bos 1, eos 2, unk 3, then the data tokens sorted.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

ATOMWISE_PATTERN = (
    r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
    r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])"
)
_TOKEN_RE = re.compile(ATOMWISE_PATTERN)

PAD, BOS, EOS, UNK = "<pad>", "<bos>", "<eos>", "<unk>"
SPECIAL_TOKENS = (PAD, BOS, EOS, UNK)


def tokenize_smiles(smiles: str) -> list[str]:
    tokens = _TOKEN_RE.findall(smiles)
    if "".join(tokens) != smiles:
        raise ValueError(f"SMILES not fully tokenizable: {smiles!r}")
    return tokens


class Tokenizer:
    def __init__(self, tokens: Iterable[str]):
        data = sorted(set(tokens) - set(SPECIAL_TOKENS))
        self.itos: list[str] = list(SPECIAL_TOKENS) + data
        self.stoi = {t: i for i, t in enumerate(self.itos)}
        self.pad_id, self.bos_id, self.eos_id, self.unk_id = 0, 1, 2, 3

    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    def encode(self, smiles: str, *, add_eos: bool = False) -> list[int]:
        ids = [self.stoi.get(t, self.unk_id) for t in tokenize_smiles(smiles)]
        return ids + [self.eos_id] if add_eos else ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            if int(i) == self.eos_id:
                break
            if int(i) not in (self.pad_id, self.bos_id):
                out.append(self.itos[int(i)])
        return "".join(out)
