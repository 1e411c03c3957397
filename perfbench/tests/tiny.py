"""Small cells for the CPU tests: the real mixes' shape at a size the CPU
runs in seconds (2 + 2 layers, d_model 64, a few slots), weights trained
for a few steps into a directory the test owns; and the decoder-only
family's tiny cell, which is data only: a configuration, a traffic mix and
limits under ``tiny_cell/``, laid out as the benchmark's own, and its
entries in ``BENCHMARK.json``'s form."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench import harness

FILES = Path(__file__).resolve().parent / "tiny_cell"
DECODER = "tiny-dense.spec-greedy.c4"
DECODER_CONFIG = {
    "name": "tiny-dense", "source": "a test size, no published model",
    "file": "perfbench/tests/tiny_cell/configs/tiny-dense.json",
    "reduced": [], "why": "2 layers, d 64, 4 heads over 2 key/value heads, "
    "RoPE, vocabulary 320: the decoder-only family on the CPU"}
DECODER_WORKLOAD = {
    "name": DECODER, "config": "tiny-dense", "traffic": "spec-greedy.c4",
    "chips": 1, "why": "speculative greedy, DL 4, N_d 3, 4 closed-loop "
    "clients 4 iterations apart, max_new 16: the tests' cell"}

CONFIG = {"n_encoder_layers": 2, "n_layers": 2, "d_model": 64, "n_heads": 4,
          "d_ff": 128}
TRAIN = {"corpus": 512, "steps": 30, "batch": 16, "warmup": 5,
         "log_every": 10, "tf32": False}


def cell(workload: str, tmp_path, *, slots: int = 4, pool: int = 64,
         warmup: int = 3, n_beams: int | None = None):
    """``workload``'s cell, cut to the CPU: its configuration at CONFIG's
    sizes (written under ``tmp_path``), ``slots`` clients."""
    c = harness.load_cell(workload)
    c = copy.deepcopy(c)
    c.config.update(CONFIG)
    c.config["train"].update(TRAIN)
    c.config_path = tmp_path / f"{c.config['name']}.json"
    c.config_path.write_text(repr(c.config))
    c.traffic.update(slots=slots, clients=slots, pool=pool,
                     warmup_iterations=warmup, max_new=16)
    if n_beams is not None:
        c.traffic["n_beams"] = n_beams
    c.limits = copy.deepcopy(c.limits)
    c.limits["sample"] = min(c.limits.get("sample", 0), 4)
    return c


def decoder_cell():
    """The tiny dense decoder-only cell (2 layers, d_model 64, 4 heads over
    2 key/value heads, vocabulary 320; 4 slots, DL 4, N_d 3, max_new 16),
    as its files give it, with every metric of ``BENCHMARK.json``."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    return harness.cell_from_files(DECODER_WORKLOAD, DECODER_CONFIG,
                                   bench["end_to_end"], bench["per_layer"],
                                   FILES)
