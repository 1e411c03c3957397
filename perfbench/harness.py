"""The benchmark's driver: reads ``BENCHMARK.json``, finds a cell's
configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), limits (``limits/<workload>.json``), model
family (``families/<family>.py``, the configuration's ``family``, default
``seq2seq``) and metric readers (``metrics/<metric>.py``) by name, and
runs the cell.

One run: the family's weights, the query pool drawn from the seed, one
``repro_torch`` ``StreamingEngine`` (the family's backend, paged cache,
one mode group of the mix's slots) driven through ``submit`` and
``serve_steps()`` by a closed loop of as many clients as slots, the
warm-up iterations, the measured window, a drain, and then, with the
program's state freed, the family's comparison with its reference.
With ``trace`` the clients go on for ``TRACE_S`` seconds after the window
under ``torch.profiler``, with the kernel metrics' entries recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import synthetic

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SPANS = ("pump", "submit", "result")
# a traced run profiles TRACE_S seconds of serving right after its window
# (enough iterations for the kernels' shares, few enough events to reduce
# in time), so the window, which its host-clock metrics read, runs with no
# profiler, and the profiler's start is in neither
TRACE_S = 10.0


# ---------------------------------------------------------------------------
# the benchmark's data


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    config_path: Path
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def family(self) -> str:
        return family_of(self.config)


def family_of(config: dict) -> str:
    """A configuration's model family: its ``family``, else ``seq2seq``."""
    return config.get("family", "seq2seq")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return cell_from_files(
        w, conf, [m for m in bench["end_to_end"] if _applies(m, workload)],
        [m for m in bench["per_layer"] if _applies(m, workload)])


def cell_from_files(w: dict, conf: dict, end_to_end: list[dict],
                    per_layer: list[dict], base: Path = HERE) -> Cell:
    """The cell of the workload entry ``w`` and its configuration's entry
    ``conf``, in ``BENCHMARK.json``'s form: the file ``conf["file"]``, and
    ``base``'s ``traffic/<traffic>.json`` and ``limits/<workload>.json``,
    with the metrics given."""
    config_path = ROOT / conf["file"]
    config = json.loads(config_path.read_text())
    mix = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{w['name']}.json").read_text())
    cell = Cell(name=w["name"], config=config, config_path=config_path,
                traffic=mix, limits=limits, end_to_end=end_to_end,
                per_layer=per_layer)
    traffic.validate(mix, w["traffic"], cell.family)
    return cell


def _load(kind: str, name: str):
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name):
        raise ValueError(f"bad {kind} name {name!r}")
    mod_name = f"perfbench.{kind}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(
        mod_name, HERE / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    return _load("metrics", name)


def family_module(name: str):
    """``families/<name>.py``: a model family's configuration, weights,
    queries, engine, prompt ids, comparison, tapped step and flops."""
    return _load("families", name)


# ---------------------------------------------------------------------------
# what a run leaves for the readers


@dataclasses.dataclass
class Completion:
    latency_s: float
    src_ids: list[int]
    tokens: np.ndarray
    lengths: np.ndarray
    logprobs: np.ndarray
    n_calls: int
    accepted: int
    finished: bool

    @property
    def src_len(self) -> int:
        return len(self.src_ids)


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict            # kernel name -> device seconds
    device_ops: list          # [[name, seconds]] top 10
    idle_gaps: list           # [[host span, seconds]] top 10


@dataclasses.dataclass
class Run:
    """What the readers read: the measured window's host-clock counts and
    completions, and in a traced run the trace of the ``TRACE_S`` seconds
    served after it with the kernel entries' bounds."""
    setup_s: float
    window_s: float
    iterations: int
    dispatches: int
    completions: list
    model_cfg: dict
    family: object = None     # the cell's family module (``query_flops``)
    trace: Trace | None = None
    bounds: dict = dataclasses.field(default_factory=dict)   # metric -> s
    patterns: dict = dataclasses.field(default_factory=dict)  # metric -> re

    def roofline(self, name: str):
        """Sum of the launches' bounds over the matching kernels' device
        time, in percent; None where nothing launched or nothing ran."""
        if self.trace is None or not self.bounds.get(name):
            return None
        pat = re.compile(self.patterns[name])
        t = sum(s for k, s in self.trace.kernel_s.items() if pat.search(k))
        return 100.0 * self.bounds[name] / t if t > 0 else None


# ---------------------------------------------------------------------------
# tracing


class EntryRecorder:
    """Wraps each kernel metric's program entries (``ENTRIES``: (module,
    attribute) -> (keep, work)) while ``active``. ``keep(args, kwargs)``
    picks what a launch's bound depends on: shapes, and the small index
    tensors, copied on the card as they stand (the program writes them
    again). ``work(*kept)`` counts bytes and flops only once the window has
    closed, so no counting runs in the traced span."""

    def __init__(self, metrics: dict):
        self.active = False
        self._kept: dict[str, list] = {}
        self._undo = []
        for name, mod in metrics.items():
            for (module, attr), fns in getattr(mod, "ENTRIES", {}).items():
                self._wrap(name, importlib.import_module(module), attr, *fns)

    def _wrap(self, name, module, attr, keep, work_fn):
        op = getattr(module, attr)
        kept = self._kept.setdefault(name, [])

        def call(*args, **kw):
            if self.active:
                kept.append((work_fn, tuple(
                    x.clone() if isinstance(x, torch.Tensor) else x
                    for x in keep(args, kw))))
            return op(*args, **kw)

        setattr(module, attr, call)
        self._undo.append((module, attr, op))

    def bounds(self) -> dict:
        """Each metric's sum of its launches' bounds, in seconds; the kept
        copies are freed."""
        from perfbench import work

        out = {}
        for name, kept in self._kept.items():
            total = sum(float(work.bound_s(*fn(*args))) for fn, args in kept)
            out[name] = total
            kept.clear()
        return out

    def close(self) -> None:
        for module, attr, op in reversed(self._undo):
            setattr(module, attr, op)
        self._undo = []


class LogitTap:
    """Keeps what the decoder step (``target``: the family's (module,
    attribute), looked up by the program at each call) of a seed-drawn
    sample of the window's calls produced, for up to ``slots`` of each
    call's active slots drawn from the seed: their ``rows`` fed rows a slot
    (the tokens, their positions) and the logits of those rows alone, so
    the comparison can judge the logits themselves. The draw and the copy
    run on the step's device, queued behind it: nothing is waited for, and
    the rest of the call's logits are left to the program."""

    def __init__(self, seed: int, period: int, calls: int, target: tuple,
                 *, rows: int, slots: int, device):
        self.active = False
        self.taps: list = []
        self._n = 0
        rng = np.random.default_rng([seed, 3])
        phase = int(rng.integers(period))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(rng.integers(2**62)))
        module = importlib.import_module(target[0])
        op = getattr(module, target[1])

        def keep(tokens, positions, logits):
            # random keys, the active slots' above every inactive one's
            n = tokens.shape[0] // rows
            key = torch.rand(n, generator=gen, device=logits.device)
            key = torch.where(positions[::rows, 0] >= 0, key, key - 2.0)
            pick = key.topk(min(slots, n)).indices
            at = (pick[:, None] * rows + torch.arange(
                rows, device=logits.device)).reshape(-1)
            return tuple(x.index_select(0, at)
                         for x in (tokens, positions, logits))

        def call(params, cfg, cache, tokens, positions, **kw):
            out = op(params, cfg, cache, tokens, positions, **kw)
            if self.active:
                if self._n % period == phase and len(self.taps) < calls:
                    self.taps.append(keep(tokens, positions, out[0]))
                self._n += 1
            return out

        setattr(module, target[1], call)
        self._undo = (module, target[1], op)

    def close(self) -> None:
        if self._undo is not None:
            setattr(*self._undo)
            self._undo = None


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce_trace(events, window=None) -> Trace:
    """``events``: (name, on_device, start_ns, end_ns) of the profiler's
    trace. The window is the ``window`` host span (or the given (start,
    end)); device busy time is the union of device intervals inside it;
    idle gaps are labelled by the benchmark's host span active at their
    start."""
    host = sorted((s, e, n) for n, dev, s, e in events
                  if not dev and n in SPANS)
    if window is None:
        win = [(s, e) for n, dev, s, e in events if not dev and n == "window"]
        window = win[0]
    w0, w1 = window
    dev = [(max(s, w0), min(e, w1), n) for n, d, s, e in events
           if d and n not in SPANS and n != "window" and e > w0 and s < w1]
    by_name: dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    starts = [h[0] for h in host]
    labelled = []
    for g0, g1 in gaps:
        i = int(np.searchsorted(starts, g0, side="right")) - 1
        label = host[i][2] if i >= 0 and host[i][1] > g0 else "host"
        labelled.append([label, (g1 - g0) / 1e9])
    labelled.sort(key=lambda x: -x[1])
    ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy_s, kernel_s=by_name,
                 device_ops=ops[:10], idle_gaps=labelled[:10])


def profiler_events(prof) -> list:
    cuda = torch._C._autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        on_dev = e.device_type() == cuda
        if on_dev and getattr(e, "is_user_annotation", lambda: False)():
            continue
        s = e.start_ns()
        out.append((e.name(), on_dev, s, s + e.duration_ns()))
    return out


# ---------------------------------------------------------------------------
# the closed loop


@dataclasses.dataclass
class LoopOut:
    done: list            # (SlotResult, latency_s, pool index) in window
    late: list            # (SlotResult, pool index) done after it
    window_s: float
    iterations: int
    dispatches: int
    missing: int
    pool_wraps: int


def closed_loop(eng, pool, clients: int, warmup: int, seconds: float, *,
                span=None, on_open=None, on_close=None, extra_s: float = 0.0,
                on_extra_end=None, drain_s: float = 60.0,
                stagger: int = 0) -> LoopOut:
    """C clients, each submitting its next query when the iteration that
    returns its result ends; client k submits its first query at the end
    of iteration ``stagger`` x k, so that clients whose requests all take
    as long do not finish together. The window opens at
    the end of iteration ``warmup`` and closes at the first iteration end
    ``seconds`` later.
    The clients go on for ``extra_s`` more seconds, counted from when
    ``on_close()`` returns, and ``on_extra_end()`` follows; then no client
    submits again, and the loop waits for what is in flight, at most
    ``drain_s``."""
    span = span or (lambda name: contextlib.nullcontext())
    inflight: dict[int, tuple[float, int]] = {}
    nxt = 0

    def submit():
        nonlocal nxt
        i = nxt % len(pool)
        nxt += 1
        t = time.perf_counter()
        inflight[int(eng.submit(pool[i][0]))] = (t, i)

    started = clients if not stagger else 1
    with span("submit"):
        for _ in range(started):
            submit()
    gen = eng.serve_steps()
    it = iterations = d0 = d1 = 0
    t0 = t1 = t2 = t3 = None
    done, late = [], []
    while True:
        with span("pump"):
            events = next(gen, None)
        now = time.perf_counter()
        if events is None:
            break
        it += 1
        timed = t0 is not None and t1 is None
        iterations += timed
        back = 0
        with span("result"):
            for r in events:
                sub = inflight.pop(int(r.rid), None)
                if sub is None:
                    continue
                back += 1
                if timed:
                    done.append((r, now - sub[0], sub[1]))
                elif t1 is not None:
                    late.append((r, sub[1]))
        if t0 is None and it >= warmup:
            d0 = eng.loop_stats()["n_dispatches"]
            if on_open:
                on_open()
            t0 = now = time.perf_counter()
        elif timed and now - t0 >= seconds:
            t1 = now
            d1 = eng.loop_stats()["n_dispatches"]
            if on_close:
                on_close()
            t2 = time.perf_counter()
            if not extra_s:
                t3 = t2
        elif t1 is not None and t3 is None and now - t2 >= extra_s:
            t3 = now
            if on_extra_end:
                on_extra_end()
        if t3 is None:
            with span("submit"):
                for _ in range(back):
                    submit()
                while started < clients and it >= stagger * started:
                    submit()
                    started += 1
        elif not inflight or time.perf_counter() - t3 > drain_s:
            break
    if t3 is None:
        raise RuntimeError("the closed loop ended before its window closed")
    return LoopOut(done=done, late=late, window_s=t1 - t0,
                   iterations=iterations, dispatches=d1 - d0,
                   missing=len(inflight),
                   pool_wraps=max(0, nxt - 1) // len(pool))


# ---------------------------------------------------------------------------
# one run


def _completion(r, latency_s: float, src_ids: list[int]) -> Completion:
    return Completion(
        latency_s=latency_s, src_ids=src_ids,
        tokens=np.asarray(r.tokens), lengths=np.asarray(r.lengths),
        logprobs=np.asarray(r.logprobs), n_calls=int(r.n_calls),
        accepted=int(r.accepted), finished=r.status.name == "FINISHED")


def build_engine(cell: Cell, w: dict, tok, device):
    """The cell's ``StreamingEngine``, built by its family."""
    return family_module(cell.family).build_engine(cell, w, tok, device)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi failed")


def host_clock() -> tuple:
    """(wall, this process's CPU seconds, the machine's steal and total
    jiffies from ``/proc/stat``, or zeros where it is not there): read at
    both ends of the window, they say how much of the host the loop had."""
    steal = total = 0
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
        steal, total = (cpu[7] if len(cpu) > 7 else 0), sum(cpu)
    except OSError:
        pass
    return time.perf_counter(), time.process_time(), steal, total


def host_share(a: tuple, b: tuple) -> str:
    wall, cpu = b[0] - a[0], b[1] - a[1]
    total = b[3] - a[3]
    steal = 100.0 * (b[2] - a[2]) / total if total else 0.0
    return (f"host: process CPU {cpu:.2f} s of {wall:.2f} s wall, "
            f"steal {steal:.2f}% of the machine's CPU time")


class ForbiddenModules(RuntimeError):
    """JAX, its libraries or the JAX package are loaded in the process."""


def forbidden_modules() -> list[str]:
    names = list(sys.modules)   # a snapshot: an import may run meanwhile
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def decide(numbers: dict, limits: dict) -> tuple[dict, bool]:
    """Every limited number beside its limit, and whether all are within:
    a number the run did not produce reads None and fails."""
    checks = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = {"value": None if v is None else float(v),
                        "limit": limit}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return checks, ok


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start: float | None = None,
             cell: Cell | None = None, drain_s: float = 60.0,
             weights_dir: Path | None = None, log=None,
             control: bool = False) -> dict:
    """One run of ``workload``; returns the result line's dict (``checks``
    last). ``cell`` overrides what ``BENCHMARK.json`` gives (the tests'
    small cells). With ``control`` the control's numbers (the reference at
    TF32 in the program's place, on the same served requests) are judged
    in the program's place, and the program's own judgement goes under
    ``program`` (``calibrate.py``; the benchmark's runs never do this).
    Raises if a forbidden module is loaded once the window has closed."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cell = cell or load_cell(workload)
    fam = family_module(cell.family)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    tok = synthetic.tokenizer()
    mcfg = fam.model_cfg(cell.config)
    if tok.vocab_size > mcfg["vocab_size"]:
        raise ValueError(f"{cell.config['name']}: vocab_size "
                         f"{mcfg['vocab_size']} < the tokenizer's "
                         f"{tok.vocab_size}")
    if dev.type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all(fam.KERNELS)
    got = fam.load_weights(cell, dev, log=log, cache_dir=weights_dir)
    log(f"weights {cell.config['name']} {got['hash']}"
        + ("" if got["trained_s"] is None
           else f" (trained in {got['trained_s']:.1f} s)"))
    w = got["weights"]
    pool = fam.queries(cell, seed, got)
    eng = build_engine(cell, w, tok, dev)
    metrics = {m["name"]: metric_module(m["name"])
               for m in cell.end_to_end + cell.per_layer}
    recorder = prof = None
    span = None
    if trace:
        if dev.type != "cuda":
            raise RuntimeError("--trace 1 reads the card's profiler trace")
        from torch.profiler import ProfilerActivity, profile, record_function
        recorder = EntryRecorder({m["name"]: metrics[m["name"]]
                                  for m in cell.per_layer})
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        span = record_function
        window_span = record_function("window")
    lim = cell.limits
    mix = cell.traffic
    tap = (LogitTap(seed, lim["tap"]["period"], lim["tap"]["calls"],
                    fam.TAP, rows=mix["n_drafts"], slots=lim["tap"]["slots"],
                    device=dev) if "tap" in lim else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = {}

    def on_open():
        marks["setup_s"] = time.perf_counter() - t_start
        marks["open"] = host_clock()
        if tap is not None:
            tap.active = True

    def on_close():
        marks["close"] = host_clock()
        if tap is not None:
            tap.active = False
        if trace:
            torch.cuda.synchronize()
            t = time.perf_counter()
            prof.start()
            log(f"profiler started in {time.perf_counter() - t:.2f} s")
            window_span.__enter__()
            recorder.active = True

    def on_trace_end():
        recorder.active = False
        torch.cuda.synchronize()
        window_span.__exit__(None, None, None)
        prof.stop()

    # set-up's objects out of the collector's way: the window's collections
    # then scan what the serving loop itself keeps
    gc.collect()
    gc.freeze()
    try:
        out = closed_loop(eng, pool, mix["clients"],
                          mix["warmup_iterations"], seconds, span=span,
                          on_open=on_open, on_close=on_close,
                          extra_s=TRACE_S if trace else 0.0,
                          on_extra_end=on_trace_end, drain_s=drain_s,
                          stagger=mix.get("stagger", 0))
    finally:
        gc.unfreeze()
        if recorder is not None:
            recorder.close()
        if tap is not None:
            tap.close()
    _sync(dev)
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(f"loaded once the window closed: {loaded}")
    stats = eng.loop_stats()
    taps = [] if tap is None else [
        (t.cpu().numpy(), p.cpu().numpy(), lg) for t, p, lg in tap.taps]
    del eng, tap
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    completions = [_completion(r, lat, fam.prompt_ids(pool[i][0], tok))
                   for r, lat, i in out.done]
    run = Run(setup_s=marks["setup_s"], window_s=out.window_s,
              iterations=out.iterations, dispatches=out.dispatches,
              completions=completions, model_cfg=mcfg, family=fam)
    if trace:
        run.trace = reduce_trace(profiler_events(prof))
        run.bounds = recorder.bounds()
        run.patterns = {n: getattr(m, "KERNELS", "") for n, m in
                        metrics.items()}
    chosen = cell.per_layer if trace else cell.end_to_end
    values = {}
    for m in chosen:
        v = metrics[m["name"]].read(run, m["name"])
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}

    t_check = time.perf_counter()
    served = completions + [_completion(r, 0.0,
                                        fam.prompt_ids(pool[i][0], tok))
                            for r, i in out.late]
    unfinished = sum(not c.finished for c in completions)

    def numbers(control: bool) -> dict:
        got = fam.judge(lim["kind"], w, mcfg, tok, completions,
                        traffic=mix, seed=seed, control=control,
                        sample_size=lim.get("sample", 0))
        if taps:
            got.update(fam.tap_numbers(
                w, mcfg, tok, taps, served, traffic=mix, seed=seed,
                slots=lim["tap"]["slots"], control=control))
        got.update(missing=float(out.missing), unfinished=float(unfinished))
        return got

    checks, ok = decide(numbers(False), lim["limits"])
    program = None
    if control:
        program = {"correct": bool(completions) and ok, "checks": checks}
        checks, ok = decide(numbers(True), lim["limits"])
    correct = bool(completions) and ok
    calls = sum(c.n_calls for c in completions)
    log(f"window {out.window_s:.3f} s, {len(completions)} completions, "
        f"{out.iterations} iterations, tokens/call "
        f"{sum(int(c.lengths[0]) for c in completions) / max(calls, 1):.3f}"
        f", pool wraps {out.pool_wraps}, loop "
        f"{json.dumps(stats)}; check {time.perf_counter() - t_check:.1f} s")
    log(host_share(marks["open"], marks["close"]))
    result = {
        "correct": correct,
        "attempted": len(completions) + out.missing,
        "failed": out.missing + unfinished,
        "metrics": values,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    if program is not None:
        result["program"] = program
    result["checks"] = checks
    return result
