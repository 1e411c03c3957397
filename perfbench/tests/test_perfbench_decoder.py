"""The decoder-only family on the CPU, in the tests' tiny cell
(``tiny.py``; data only: a configuration, a traffic mix and limits): the
plain reference against the program's ``transformer.apply`` on seeded
weights, a sound run reads ``correct``, each fault the cell can have reads
not correct, the control is judged in the program's place, the family is
found by the configuration's ``family`` key, the logit tap keeps only the
slots it samples, and staggered clients start apart."""

from __future__ import annotations

import copy
import json
import sys
import types

import pytest
import torch

from perfbench import faults, harness, traffic
from perfbench.reference import decoder as ref
from perfbench.tests import tiny

SEED = 2**31 + 23
# the reference against the program's full-sequence forward: both fp32 on
# the CPU, differing only in the order of their sums (the flash kernels'
# plain version against einsums), a few ulps of logits near unit scale;
# computing in any lower precision moves them by 1e-3 or more
APPLY_TOL = 1e-5


@pytest.fixture(scope="module")
def cell():
    return tiny.decoder_cell()


def _run(cell, **kw):
    return harness.run_cell(tiny.DECODER, SEED, 2.0, False, device="cpu",
                            cell=cell, log=lambda *a: None, **kw)


@pytest.mark.parametrize("pos,tied", [("rope", False), ("none", True)])
def test_reference_equals_the_programs_apply(cell, pos, tied):
    config = copy.deepcopy(cell.config)
    config["model"].update(pos=pos, tie_embeddings=tied)
    fam = harness.family_module("decoder_only")
    cfg = fam.model_cfg(config)
    w = ref.init(cfg, 3, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 40),
                           generator=torch.Generator().manual_seed(4))
    from repro_torch.models import transformer as tr

    want = ref.head(w, cfg, ref.hidden(w, cfg, tokens))
    got, _ = tr.apply(fam.port_params(w, cfg), fam.port_config(config),
                      tokens)
    assert want.abs().max() > 1.0   # logits near unit scale
    assert float((got - want).abs().max()) <= APPLY_TOL


def test_each_logits_covers_every_span(cell):
    """Rows of many lengths in blocks: each row's span, as one forward of
    that row alone gives it."""
    cfg = harness.family_module("decoder_only").model_cfg(cell.config)
    w = ref.init(cfg, 3, "cpu")
    g = torch.Generator().manual_seed(5)
    rows = [torch.randint(0, 320, (n,), generator=g).tolist()
            for n in (7, 30, 12, 30, 3)]
    spans = [(len(r) - 3, len(r)) for r in rows]
    seen = {}
    ref.each_logits(w, cfg, rows, spans, lambda k, x: seen.setdefault(k, x),
                    block_tokens=64)
    assert sorted(seen) == list(range(len(rows)))
    for k, r in enumerate(rows):
        alone = ref.head(w, cfg, ref.hidden(w, cfg, torch.tensor([r])))[0]
        assert torch.allclose(seen[k], alone[spans[k][0]:], atol=1e-5)


def test_reference_refuses_what_it_does_not_cover(cell):
    cfg = harness.family_module("decoder_only").model_cfg(cell.config)
    for key, value in (("layer_pattern", ["mamba"]), ("qk_norm", True),
                       ("pos", "sinusoidal"), ("use_bias", True)):
        with pytest.raises(ValueError, match=key.split("_")[0]):
            ref.check(dict(cfg, **{key: value}))


def test_a_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.limits["limits"])
    assert set(r["metrics"]) == {"queries_per_s", "latency_p95_ms",
                                 "setup_s"}


@pytest.mark.parametrize("fault", faults.applicable("greedy",
                                                    "decoder_only"))
def test_a_planted_fault_is_not_correct(cell, fault):
    with faults.planted(fault):
        r = _run(cell, drain_s=2.0)
    assert not r["correct"], r["checks"]


def test_the_control_is_judged_in_the_programs_place(cell):
    r = _run(cell, control=True)
    assert r["program"]["correct"], r["program"]["checks"]
    assert set(r["checks"]) == set(cell.limits["limits"])
    assert all(c["value"] is not None for c in r["checks"].values())


def test_model_mfu_reads_the_familys_flops(cell):
    fam = harness.family_module("decoder_only")
    cfg = fam.model_cfg(cell.config)
    c = harness.Completion(latency_s=0.1, src_ids=[5] * 10,
                           tokens=torch.zeros((1, 16)).numpy(),
                           lengths=torch.tensor([4]).numpy(),
                           logprobs=torch.zeros(1).numpy(), n_calls=4,
                           accepted=0, finished=True)
    run = harness.Run(setup_s=1.0, window_s=1.0, iterations=4, dispatches=4,
                      completions=[c], model_cfg=cfg, family=fam)
    # 13 positions through 2 layers of d 64 (q, k, v, o: 64 x 64, 2 x 64 x
    # 32; FFN 3 x 64 x 128), 91 attended keys, the head at 4 of them
    per_token = 2 * 64 * 64 + 4 * 64 * 32 + 2 * 64 * 64 + 6 * 64 * 128
    want = 2 * (13 * per_token + 4 * 64 * 91) + 4 * 2 * 64 * 320
    assert ref.query_flops(cfg, 10, 4) == want
    mfu = harness.metric_module("model_mfu").read(run, "model_mfu")
    assert mfu == pytest.approx(100.0 * want / 67e12)


def test_the_family_is_found_by_name(cell):
    assert cell.family == "decoder_only"
    mt = harness.load_cell("mt-product.spec-greedy.c128")
    assert "family" not in mt.config and mt.family == "seq2seq"
    with pytest.raises(ValueError):
        harness.family_module("../harness")


def test_prefill_chunk_is_a_decoder_only_key(cell):
    traffic.validate(cell.traffic, "spec-greedy.c4", "decoder_only")
    with pytest.raises(ValueError, match="prefill_chunk"):
        traffic.validate(cell.traffic, "spec-greedy.c4")
    mix = dict(cell.traffic)
    del mix["prefill_chunk"]
    with pytest.raises(ValueError, match="prefill_chunk"):
        traffic.validate(mix, "spec-greedy.c4", "decoder_only")


@pytest.mark.gpu
def test_the_tiny_cell_on_the_card(cell):
    """A sound run on the card reads ``correct``; the reference in TF32 in
    the program's place does not (``-m gpu``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run_cell(tiny.DECODER, SEED, 3.0, False, cell=cell)
    assert r["correct"], r["checks"]
    r = harness.run_cell(tiny.DECODER, SEED + 1, 3.0, False, cell=cell,
                         control=True)
    assert r["program"]["correct"], r["program"]["checks"]
    assert not r["correct"], r["checks"]


def test_the_tiny_cell_is_data(cell):
    """The tiny cell is files only: its configuration builds the program's
    ``ModelConfig`` and names a reference that covers it, and it carries
    every metric of the benchmark."""
    fam = harness.family_module(cell.family)
    pcfg = fam.port_config(cell.config)
    cfg = fam.model_cfg(cell.config)
    assert pcfg.vocab_size == cfg["vocab_size"]
    assert fam.reference(cfg).weight_shapes(cfg)
    assert cell.limits["kind"] == "greedy"
    assert cell.config["precision"] == "float32"
    assert cell.config["tf32"] is False
    assert sorted(tiny.FILES.rglob("*.json")) == sorted(
        [cell.config_path, tiny.FILES / "traffic" / "spec-greedy.c4.json",
         tiny.FILES / "limits" / f"{tiny.DECODER}.json"])
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert cell.end_to_end + cell.per_layer == (bench["end_to_end"]
                                                + bench["per_layer"])


def _tapped(monkeypatch, seed, slots, rows=3, groups=6, active=(1, 3, 4)):
    """A LogitTap over a fake step fed ``groups`` slots of ``rows`` rows,
    only ``active`` of them active; returns (the step's logits, the tap's
    one kept (tokens, positions, logits))."""
    mod = types.ModuleType("perfbench_tests_fake_step")
    mod.decode_step = lambda params, cfg, cache, tokens, positions: (
        logits, cache)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    n = groups * rows
    tokens = torch.arange(n)[:, None].repeat(1, 5)
    positions = torch.full((n, 5), -1)
    for g in active:
        positions[g * rows:(g + 1) * rows] = 7
    logits = torch.randn(n, 5, 11)
    tap = harness.LogitTap(seed, 1, 1, (mod.__name__, "decode_step"),
                           rows=rows, slots=slots, device="cpu")
    tap.active = True
    mod.decode_step(None, None, None, tokens, positions)
    tap.close()
    assert len(tap.taps) == 1
    return logits, tap.taps[0]


@pytest.mark.parametrize("slots", [2, 3, 5])
def test_the_tap_keeps_only_the_slots_it_samples(monkeypatch, slots):
    """Of a tapped call, ``slots`` slots' rows are kept, active ones first
    and drawn from the seed, each row whole (its tokens, positions and
    logits together), and nothing of the other slots."""
    logits, (tk, ps, lg) = _tapped(monkeypatch, SEED, slots)
    assert lg.shape == (slots * 3, 5, 11)
    kept = tk[::3, 0].div(3, rounding_mode="floor").tolist()
    assert len(set(kept)) == slots
    assert set(kept[:min(slots, 3)]) <= {1, 3, 4}
    if slots >= 3:
        assert {1, 3, 4} <= set(kept)
    for r in range(lg.shape[0]):
        assert torch.equal(lg[r], logits[int(tk[r, 0])])
        assert int(ps[r, 0]) == (7 if int(tk[r, 0]) // 3 in (1, 3, 4)
                                 else -1)
    again = _tapped(monkeypatch, SEED, slots)[1][0]
    assert torch.equal(again, tk)


def test_two_active_slots_of_three_are_drawn_from_the_seed(monkeypatch):
    seen = {tuple(sorted(_tapped(monkeypatch, s, 2)[1][0][::3, 0].div(
        3, rounding_mode="floor").tolist())) for s in range(12)}
    assert seen <= {(1, 3), (1, 4), (3, 4)} and len(seen) > 1


class _Fixed:
    """An engine whose every request is served ``length`` iterations after
    its submission; records the iteration of each submission."""

    def __init__(self, length: int):
        self.length, self.it, self.rid = length, 0, 0
        self.due: dict[int, int] = {}
        self.submitted: list[int] = []

    def submit(self, q):
        self.rid += 1
        self.due[self.rid] = self.it + self.length
        self.submitted.append(self.it)
        return self.rid

    def loop_stats(self):
        return {"n_dispatches": self.it}

    def serve_steps(self):
        while self.due:
            self.it += 1
            done = [r for r, t in self.due.items() if t <= self.it]
            for r in done:
                del self.due[r]
            yield [types.SimpleNamespace(rid=r) for r in done]


def test_staggered_clients_start_apart():
    """Client k submits its first query at the end of iteration stagger x
    k; with requests that all take as long, the clients then finish apart
    every round, and without a stagger all together."""
    eng = _Fixed(8)
    out = harness.closed_loop(eng, [("q", "")], 4, 6, 0.05, drain_s=0.0,
                              stagger=2)
    assert eng.submitted[:4] == [0, 2, 4, 6]
    assert sorted(set(eng.submitted[4:8])) == [8, 10, 12, 14]
    assert out.done
    eng = _Fixed(8)
    harness.closed_loop(eng, [("q", "")], 4, 6, 0.05, drain_s=0.0)
    assert eng.submitted[:8] == [0] * 4 + [8] * 4


def test_a_stagger_past_the_warmup_is_refused(cell):
    mix = dict(cell.traffic)
    traffic.validate(mix, "spec-greedy.c4", "decoder_only")
    mix["stagger"] = mix["warmup_iterations"] // (mix["clients"] - 1) + 1
    with pytest.raises(ValueError, match="warm-up"):
        traffic.validate(mix, "spec-greedy.c4", "decoder_only")
