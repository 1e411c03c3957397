"""Atomwise SMILES tokenizer (Schwaller et al., 2019).

The standard regex splits a SMILES string into chemically meaningful tokens:
bracket atoms (``[nH]``, ``[C@@H]``), two-letter elements (``Cl``, ``Br``),
ring-bond digits, bond symbols, and parentheses. The same vocabulary is shared
by encoder and decoder, as in the Molecular Transformer.
"""

from __future__ import annotations

import re
from typing import Iterable, Sequence

import numpy as np

# Schwaller et al. (2019) atomwise tokenization pattern.
ATOMWISE_PATTERN = (
    r"(\[[^\]]+]|Br?|Cl?|N|O|S|P|F|I|b|c|n|o|s|p|\(|\)|\.|=|#|-|\+|\\|\/|:"
    r"|~|@|\?|>|\*|\$|\%[0-9]{2}|[0-9])"
)
_TOKEN_RE = re.compile(ATOMWISE_PATTERN)

PAD, BOS, EOS, UNK = "<pad>", "<bos>", "<eos>", "<unk>"
SPECIAL_TOKENS = (PAD, BOS, EOS, UNK)


def tokenize_smiles(smiles: str) -> list[str]:
    """Split a SMILES string into atomwise tokens; raises on untokenizable text."""
    tokens = _TOKEN_RE.findall(smiles)
    if "".join(tokens) != smiles:
        raise ValueError(f"SMILES not fully tokenizable: {smiles!r}")
    return tokens


class SmilesTokenizer:
    """Vocabulary + encode/decode for atomwise SMILES tokens.

    ids: pad=0, bos=1, eos=2, unk=3, then data tokens sorted for determinism.
    """

    def __init__(self, tokens: Iterable[str] = ()):  # tokens: data vocabulary
        data_tokens = sorted(set(tokens) - set(SPECIAL_TOKENS))
        self.itos: list[str] = list(SPECIAL_TOKENS) + data_tokens
        self.stoi: dict[str, int] = {t: i for i, t in enumerate(self.itos)}

    # --- construction -----------------------------------------------------
    @classmethod
    def from_corpus(cls, smiles_corpus: Iterable[str]) -> "SmilesTokenizer":
        vocab: set[str] = set()
        for s in smiles_corpus:
            vocab.update(tokenize_smiles(s))
        return cls(vocab)

    # --- properties -------------------------------------------------------
    @property
    def vocab_size(self) -> int:
        return len(self.itos)

    @property
    def pad_id(self) -> int:
        return self.stoi[PAD]

    @property
    def bos_id(self) -> int:
        return self.stoi[BOS]

    @property
    def eos_id(self) -> int:
        return self.stoi[EOS]

    @property
    def unk_id(self) -> int:
        return self.stoi[UNK]

    # --- encode/decode ----------------------------------------------------
    def encode(
        self, smiles: str, *, add_bos: bool = False, add_eos: bool = False
    ) -> list[int]:
        ids = [self.stoi.get(t, self.unk_id) for t in tokenize_smiles(smiles)]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def encode_padded(
        self, smiles: str, max_len: int, *, add_bos: bool = False, add_eos: bool = True
    ) -> np.ndarray:
        ids = self.encode(smiles, add_bos=add_bos, add_eos=add_eos)[:max_len]
        out = np.full((max_len,), self.pad_id, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int], *, strip_special: bool = True) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if strip_special and i == self.eos_id:
                break
            if strip_special and i in (self.pad_id, self.bos_id):
                continue
            toks.append(self.itos[i])
        return "".join(toks)

    # --- persistence ------------------------------------------------------
    def to_dict(self) -> dict:
        return {"itos": self.itos}

    @classmethod
    def from_dict(cls, d: dict) -> "SmilesTokenizer":
        tok = cls.__new__(cls)
        tok.itos = list(d["itos"])
        tok.stoi = {t: i for i, t in enumerate(tok.itos)}
        return tok
