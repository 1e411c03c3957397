"""A small cell for the CPU tests: the real mixes' shape at a size the CPU
runs in seconds (2 + 2 layers, d_model 64, a few slots), weights trained
for a few steps into a directory the test owns."""

from __future__ import annotations

import copy

from perfbench import harness

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
