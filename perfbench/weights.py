"""Each configuration's weights: trained by the plain trainer
(``reference/train.py``) on a checkout's first run and cached in a fixed
directory inside it (``perfbench/.cache/weights``), keyed by a hash of the
configuration file and the reference's sources; later runs load the file.
``port_params`` hands them to the program in ``seq2seq.init``'s layout.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import torch

from perfbench.reference import train

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache" / "weights"
_SOURCES = ("model.py", "train.py", "synthetic.py", "tokenizer.py")


def model_cfg(config: dict) -> dict:
    """The reference's view of a configuration file's sizes."""
    return {k: config[k] for k in ("n_layers", "n_encoder_layers", "d_model",
                                   "n_heads", "d_ff", "vocab_size",
                                   "max_len")}


def cache_key(config_path: Path) -> str:
    h = hashlib.sha256(Path(config_path).read_bytes())
    for name in _SOURCES:
        h.update((HERE / "reference" / name).read_bytes())
    return h.hexdigest()[:16]


def trained(config: dict, config_path: Path, device, log=print,
            cache_dir: Path = CACHE) -> dict:
    """``{"weights", "hash", "train_sources", "trained_s"}``: loaded from
    the cache, or trained and written there (``trained_s`` None on a
    load)."""
    path = Path(cache_dir) / f"{config['name']}-{cache_key(config_path)}.pt"
    if path.exists():
        blob = torch.load(path, map_location=device, weights_only=True)
        return {"weights": blob["weights"], "hash": blob["hash"],
                "train_sources": set(blob["train_sources"]),
                "trained_s": None}
    out = train.train(model_cfg(config), config["train"], config["task"],
                      device, log=log)
    if torch.device(device).type == "cuda":   # the trainer's memory back
        torch.cuda.empty_cache()
    digest = train.weights_hash(out["weights"])
    path.parent.mkdir(parents=True, exist_ok=True)
    partial = path.with_suffix(".partial")
    torch.save({"weights": {k: v.cpu() for k, v in out["weights"].items()},
                "hash": digest, "train_sources": out["train_sources"],
                "losses": out["losses"]}, partial)
    os.replace(partial, path)
    return {"weights": out["weights"], "hash": digest,
            "train_sources": set(out["train_sources"]),
            "trained_s": out["seconds"]}


def port_params(w: dict, cfg: dict) -> dict:
    """The reference's flat weights as ``repro_torch.models.seq2seq``'s
    nested tree (copies: the program may write what it is given)."""
    def t(name):
        return w[name].detach().clone()

    def dense(p, n):
        return {"w": t(f"{p}.w{n}"), "b": t(f"{p}.b{n}")}

    def attn(p):
        return {f"w{n}": dense(p, n) for n in ("q", "k", "v", "o")}

    def norm(p):
        return {"scale": t(f"{p}.g"), "bias": t(f"{p}.b")}

    def ffn(p):
        return {"w_in": {"w": t(f"{p}.w1"), "b": t(f"{p}.b1")},
                "w_out": {"w": t(f"{p}.w2"), "b": t(f"{p}.b2")}}

    return {
        "tok": {"embed": t("tok")},
        "enc_blocks": [{"norm1": norm(f"enc.{i}.ln1"),
                        "attn": attn(f"enc.{i}.attn"),
                        "norm2": norm(f"enc.{i}.ln2"),
                        "ffn": ffn(f"enc.{i}.ffn")}
                       for i in range(cfg["n_encoder_layers"])],
        "enc_norm": norm("enc_ln"),
        "dec_blocks": [{"norm1": norm(f"dec.{i}.ln1"),
                        "self_attn": attn(f"dec.{i}.self"),
                        "norm_x": norm(f"dec.{i}.lnx"),
                        "cross_attn": attn(f"dec.{i}.cross"),
                        "norm2": norm(f"dec.{i}.ln2"),
                        "ffn": ffn(f"dec.{i}.ffn")}
                       for i in range(cfg["n_layers"])],
        "dec_norm": norm("dec_ln"),
        "lm_head": {"w_vocab": t("out")},
    }
