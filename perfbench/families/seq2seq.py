"""The seq2seq family: the Molecular Transformer as ``BENCHMARK.json``'s
first cells serve it. Weights trained by the plain trainer and cached
(``weights.py``), queries drawn in the configuration's ``task`` direction
past its training corpus (``traffic.queries``), the engine's seq2seq
backend with the MT's fixed norm, positions and biases, and the
comparison with ``reference/model.py`` (``check.py``), whose logit tap
wraps ``repro_torch.models.seq2seq.decode_step``.
"""

from __future__ import annotations

from perfbench import check, traffic, weights, work

# what the card builds before set-up serves, and the decoder step that the
# logit tap wraps (the program looks it up at each call)
KERNELS = ("flash_attention", "paged_decode_gqa", "draft_verify")
TAP = ("repro_torch.models.seq2seq", "decode_step")

judge = check.judge
tap_numbers = check.tap_numbers


def model_cfg(config: dict) -> dict:
    return weights.model_cfg(config)


def load_weights(cell, device, *, log, cache_dir=None) -> dict:
    """Trained on a checkout's first run, loaded from the cache after;
    ``hash`` the weights' sha256."""
    got = weights.trained(cell.config, cell.config_path, device, log=log,
                          cache_dir=cache_dir or weights.CACHE)
    return dict(got, hash=f"sha256 {got['hash']}")


def queries(cell, seed: int, got: dict) -> list:
    return traffic.queries(cell.traffic, cell.config["task"], seed,
                           got["train_sources"])


def prompt_ids(query: str, tok) -> list[int]:
    return tok.encode(query, add_eos=True)


def query_flops(cfg: dict, completion) -> int:
    return work.mt_query_flops(cfg, completion.src_len, completion.lengths)


def port_config(config: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=config["name"], family="seq2seq", n_layers=config["n_layers"],
        n_encoder_layers=config["n_encoder_layers"],
        d_model=config["d_model"], n_heads=config["n_heads"],
        n_kv_heads=config["n_heads"], d_ff=config["d_ff"],
        vocab_size=config["vocab_size"], use_bias=True, norm="layernorm",
        gated_ffn=False, pos="sinusoidal", max_len=config["max_len"])


def port_tokenizer(tok, vocab_size: int):
    """The frozen tokenizer as the program's, its inventory first and the
    rest of the model's vocabulary as reserved entries."""
    from repro_torch.data.tokenizer import SmilesTokenizer

    itos = list(tok.itos) + [f"<unused{i}>"
                             for i in range(tok.vocab_size, vocab_size)]
    return SmilesTokenizer.from_dict({"itos": itos})


def build_engine(cell, w: dict, tok, device):
    from repro_torch.serving.engine import EngineConfig, StreamingEngine

    mix = cell.traffic
    ecfg = EngineConfig(
        mode=mix["mode"], draft_len=mix["draft_len"],
        n_drafts=mix["n_drafts"], n_beams=mix["n_beams"],
        max_new=mix["max_new"], max_src=mix["max_src"],
        n_slots=mix["slots"], mode_groups={mix["mode"]: mix["slots"]},
        paged=True, page_size=mix["page_size"], backend="seq2seq")
    params = weights.port_params(w, weights.model_cfg(cell.config))
    return StreamingEngine(params, port_config(cell.config),
                           port_tokenizer(tok, cell.config["vocab_size"]),
                           ecfg, device=device)
