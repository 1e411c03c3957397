"""Synthetic reactions: a frozen copy of the program's generator, kept with
the benchmark so that the traffic and the training corpus do not move when
the program changes.

Products share long token runs with their reactants, because a reaction
leaves large fragments untouched: the property that source-copy drafts
rely on. Three templates: ``addition`` (scaffold + activated fragment ->
scaffold(fragment)), ``removal`` (scaffold(fragment) -> scaffold) and
``swap`` (a leaving group replaced by a nucleophile). The forward task
maps reactants to the product, the retro task the product to reactants.
"""

from __future__ import annotations

import numpy as np

from .tokenizer import Tokenizer, tokenize_smiles

_CHAIN_ATOMS = ["C", "C", "C", "c", "c", "N", "O", "n", "S"]
_DECOR = ["F", "Cl", "Br", "=O", "C", "OC", "N"]
_BRACKET = ["[nH]", "[C@@H]", "[C@H]", "[O-]", "[N+]"]
FRAGMENTS = ["C(=O)OC(C)(C)C", "C(=O)OCc1ccccc1", "S(=O)(=O)C", "C(=O)C",
             "Cc1ccccc1", "C(F)(F)F", "OCC", "N(C)C"]
LEAVING_GROUPS = ["Cl", "Br", "I", "OS(=O)(=O)C"]


def _scaffold(rng: np.random.Generator, n_atoms: int) -> str:
    out: list[str] = []
    ring_open = False
    ring_digit = str(rng.integers(1, 5))
    aromatic_run = 0
    ring_close_at = -1
    i = 0
    while i < n_atoms:
        a = _CHAIN_ATOMS[rng.integers(len(_CHAIN_ATOMS))]
        if aromatic_run > 0:
            a = "c"
            aromatic_run -= 1
        out.append(a)
        if not ring_open and a == "c" and rng.random() < 0.6 and i + 5 < n_atoms:
            out.append(ring_digit)
            ring_open = True
            aromatic_run = 5
            ring_close_at = i + 5
        elif ring_open and i == ring_close_at:
            out.append(ring_digit)
            ring_open = False
        if rng.random() < 0.25 and not aromatic_run:
            out += ["(", _DECOR[rng.integers(len(_DECOR))], ")"]
        if rng.random() < 0.06 and not aromatic_run:
            out.append(_BRACKET[rng.integers(len(_BRACKET))])
            i += 1
        i += 1
    if ring_open:
        out += ["c", ring_digit]
    return "".join(out)


def reaction(rng: np.random.Generator) -> tuple[str, str]:
    """(reactants, product) of one synthetic reaction."""
    scaffold = _scaffold(rng, int(rng.integers(8, 22)))
    frag = FRAGMENTS[rng.integers(len(FRAGMENTS))]
    kind = ["addition", "removal", "swap"][rng.integers(3)]
    if kind == "addition":
        lg = LEAVING_GROUPS[rng.integers(len(LEAVING_GROUPS))]
        return f"{scaffold}.{frag}{lg}", f"{scaffold}({frag})"
    if kind == "removal":
        return f"{scaffold}({frag})", scaffold
    lg = LEAVING_GROUPS[rng.integers(len(LEAVING_GROUPS))]
    nuc = FRAGMENTS[rng.integers(len(FRAGMENTS))]
    return f"{scaffold}({lg}).{nuc}", f"{scaffold}({nuc})"


def pairs(n: int, seed: int, task: str) -> list[tuple[str, str]]:
    """``n`` (source, target) pairs drawn from ``seed``: forward = reactants
    to product, retro = product to reactants."""
    if task not in ("forward", "retro"):
        raise ValueError(f"unknown task {task!r}")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r, p = reaction(rng)
        out.append((r, p) if task == "forward" else (p, r))
    return out


def tokenizer() -> Tokenizer:
    """The fixed inventory: every token the generator can emit, so the
    vocabulary does not depend on a corpus or a seed."""
    inv: set[str] = set()
    for s in (_CHAIN_ATOMS + _DECOR + _BRACKET + FRAGMENTS + LEAVING_GROUPS
              + ["%10", "(", ")", ".", "1", "2", "3", "4"]):
        inv.update(tokenize_smiles(s))
    return Tokenizer(inv)
