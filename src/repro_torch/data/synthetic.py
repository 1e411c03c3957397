"""Synthetic reaction data generator.

USPTO-MIT / USPTO-50K are not available offline, so we generate reactions that
preserve the *structural property the paper exploits*: product SMILES share long
token substrings with reactant SMILES, because chemical transformations leave
large fragments untouched (Andronov et al. §2.1; Zhong et al. 2022 root-aligned
SMILES maximize this overlap).

Molecules here are random SMILES-like token strings (balanced parentheses,
paired ring digits, valid atomwise tokens) — chemically plausible-looking, not
chemically validated; the framework's claims (acceptance rate, speedup,
accuracy-neutrality) depend only on token statistics and substring sharing.

Reaction templates:
  - ``addition``:   scaffold + reagent fragment  -> decorated scaffold
                    (e.g. Boc protection, as in the paper's Figure 2)
  - ``removal``:    decorated scaffold           -> bare scaffold (+ byproduct)
  - ``swap``:       scaffold with leaving group + nucleophile -> substituted
Both directions (product prediction / retrosynthesis) come from the same pair.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from repro_torch.data.tokenizer import SmilesTokenizer, tokenize_smiles

# Token inventory for random scaffolds.
_CHAIN_ATOMS = ["C", "C", "C", "c", "c", "N", "O", "n", "S"]
_DECOR = ["F", "Cl", "Br", "=O", "C", "OC", "N"]
_BRACKET = ["[nH]", "[C@@H]", "[C@H]", "[O-]", "[N+]"]

# Common protecting/functional groups — realistic long shared fragments.
FRAGMENTS = [
    "C(=O)OC(C)(C)C",       # Boc
    "C(=O)OCc1ccccc1",      # Cbz
    "S(=O)(=O)C",           # mesyl
    "C(=O)C",               # acetyl
    "Cc1ccccc1",            # benzyl
    "C(F)(F)F",             # CF3
    "OCC",                  # ethoxy
    "N(C)C",                # dimethylamino
]
LEAVING_GROUPS = ["Cl", "Br", "I", "OS(=O)(=O)C"]


def _random_scaffold(rng: np.random.Generator, n_atoms: int) -> str:
    """A balanced, tokenizable SMILES-like string with rings and branches."""
    out: list[str] = []
    ring_open = False
    ring_digit = str(rng.integers(1, 5))
    aromatic_run = 0
    i = 0
    while i < n_atoms:
        a = _CHAIN_ATOMS[rng.integers(len(_CHAIN_ATOMS))]
        if aromatic_run > 0:
            a = "c"
            aromatic_run -= 1
        out.append(a)
        # open an aromatic ring: c1ccccc1-like run
        if not ring_open and a == "c" and rng.random() < 0.6 and i + 5 < n_atoms:
            out.append(ring_digit)
            ring_open = True
            aromatic_run = 5
            ring_close_at = i + 5
        elif ring_open and i == ring_close_at:
            out.append(ring_digit)
            ring_open = False
        # random branch
        if rng.random() < 0.25 and not aromatic_run:
            d = _DECOR[rng.integers(len(_DECOR))]
            out.append("(")
            out.append(d)
            out.append(")")
        # occasional bracket atom
        if rng.random() < 0.06 and not aromatic_run:
            out.append(_BRACKET[rng.integers(len(_BRACKET))])
            i += 1
        i += 1
    if ring_open:  # close dangling ring
        out.append("c")
        out.append(ring_digit)
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class Reaction:
    reactants: str  # '.'-joined reactant SMILES
    product: str
    template: str


def make_reaction(rng: np.random.Generator) -> Reaction:
    """One synthetic reaction with guaranteed reactant/product substring overlap."""
    scaffold = _random_scaffold(rng, int(rng.integers(8, 22)))
    frag = FRAGMENTS[rng.integers(len(FRAGMENTS))]
    kind = ["addition", "removal", "swap"][rng.integers(3)]
    if kind == "addition":
        # scaffold + activated fragment -> scaffold(frag)
        lg = LEAVING_GROUPS[rng.integers(len(LEAVING_GROUPS))]
        reactants = f"{scaffold}.{frag}{lg}"
        product = f"{scaffold}({frag})"
    elif kind == "removal":
        reactants = f"{scaffold}({frag})"
        product = scaffold
    else:  # swap: leaving group replaced by nucleophile fragment
        lg = LEAVING_GROUPS[rng.integers(len(LEAVING_GROUPS))]
        nuc = FRAGMENTS[rng.integers(len(FRAGMENTS))]
        reactants = f"{scaffold}({lg}).{nuc}"
        product = f"{scaffold}({nuc})"
    # both sides must tokenize cleanly
    tokenize_smiles(reactants)
    tokenize_smiles(product)
    return Reaction(reactants=reactants, product=product, template=kind)


class SyntheticReactionDataset:
    """Deterministic synthetic reaction corpus + shared tokenizer.

    ``direction='forward'`` : source=reactants, target=product  (product prediction)
    ``direction='retro'``   : source=product,  target=reactants (retrosynthesis)
    """

    def __init__(self, n: int, *, seed: int = 0, direction: str = "forward"):
        assert direction in ("forward", "retro")
        rng = np.random.default_rng(seed)
        self.reactions = [make_reaction(rng) for _ in range(n)]
        self.direction = direction
        corpus = [r.reactants for r in self.reactions] + [
            r.product for r in self.reactions
        ]
        # Fixed inventory so tokenizers agree across dataset sizes/seeds.
        inventory = set()
        for s in corpus:
            inventory.update(tokenize_smiles(s))
        for s in FRAGMENTS + LEAVING_GROUPS + _BRACKET + ["%10"]:
            inventory.update(tokenize_smiles(s))
        self.tokenizer = SmilesTokenizer(inventory)

    def __len__(self) -> int:
        return len(self.reactions)

    def pair(self, i: int) -> tuple[str, str]:
        r = self.reactions[i]
        if self.direction == "forward":
            return r.reactants, r.product
        return r.product, r.reactants

    def pairs(self) -> Iterator[tuple[str, str]]:
        for i in range(len(self)):
            yield self.pair(i)
