"""Set-up and the timed window: an open loop over the port's serving stack.

Set-up builds the cell's remote tier on a ``JitBackend`` and the hedge
tier on an ``OnDeviceBackend`` (the deployment of ``launch/serve.py``'s
``build_engine``), with the benchmark's own seeded weights, measures both
tiers' profiles at the mix's median request (the system's own Table III
set-up, which also builds and loads every kernel the window runs), and
builds the scheduler on them.

The window sends each request at its due time on the wall clock and
drives ``ServingLoop.submit`` / ``tick`` / ``poll`` with async dispatch:
a tick at every scheduling-window boundary, polls in between.  Once the
window has closed, ticks and polls go on until every request sent has its
answer, for at most a minute.  Every time is taken from the request's due
time on one ``perf_counter`` clock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import numpy as np

from perfbench import loadgen, weights
from perfbench.reference.check import Served

DRAIN_LIMIT_S = 60.0


@dataclasses.dataclass
class Tier:
    name: str
    cfg: object  # the port's ModelConfig
    params: dict
    quality: float


@dataclasses.dataclass
class Record:
    """One request sent in the window."""

    rid: int
    prompt_len: int
    n_steps: int
    answered: bool
    used_remote: Optional[bool]
    remote_ms: Optional[float]  # due time -> remote tier done
    answer_ms: Optional[float]  # due time -> the answer reaches the user
    queue_wait_ms: Optional[float]


@dataclasses.dataclass
class WindowResult:
    records: List[Record]
    served: List[Served]
    ticks: list  # TickStats of every collected tick
    lateness_ms: np.ndarray  # how late each request was submitted
    window_s: float  # from the window's start to the last answer
    spans: List[tuple]  # (name, start_ns, end_ns) on the perf_counter clock


def model_config(fields: dict):
    from repro_torch.models.config import ModelConfig

    known = {f.name for f in dataclasses.fields(ModelConfig)}
    args = {k: (tuple(v) if isinstance(v, list) else v) for k, v in fields.items() if k in known}
    return ModelConfig(**args)


def make_tier(spec: dict, seed: int, device) -> Tier:
    from perfbench.reference.model import Spec

    cfg = model_config(spec["model"])
    params = weights.make_params(Spec.from_dict(spec["model"]), f"{seed}:{spec['name']}", device)
    return Tier(spec["name"], cfg, params, float(spec["quality"]))


class Spans:
    """Host spans of the benchmark's own calls (thread-safe appends)."""

    def __init__(self):
        self.items: List[tuple] = []
        self._lock = threading.Lock()

    def add(self, name, t0, t1):
        with self._lock:
            self.items.append((name, t0, t1))


class Engine:
    """The deployment under test, built from the cell's tiers."""

    def __init__(self, remote: Tier, hedge: Tier, mix: dict, seed: int, device,
                 spans: Optional[Spans] = None):
        from repro_torch.models import transformer as T
        from repro_torch.serving.backend import JitBackend, OnDeviceBackend, Variant
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig

        for tier in (remote, hedge):  # the tree must be the one the port takes
            want = weights.leaf_shapes(tier.cfg)
            spec = T.model_spec(tier.cfg)
            got = {("periods", "0") + k[2:] if k[0] == "periods" else k: v
                   for k, v in _flat(spec).items()}
            got = {k: ((tier.cfg.n_layers, *v) if k[0] == "periods" else v)
                   for k, v in got.items()}
            if got != want:
                raise RuntimeError(f"{tier.name}: the port's parameter tree differs "
                                   f"from the benchmark's: {sorted(set(got) ^ set(want))}")
        max_len = int(mix["max_len"])
        self.remote, self.hedge = remote, hedge
        self.backend = JitBackend(max_len, device=device)
        self.hedge_backend = OnDeviceBackend(
            Variant(hedge.name, hedge.cfg, hedge.params, hedge.quality),
            max_len=max_len, device=device)
        self.engine = ServingEngine(max_len=max_len, backend=self.backend,
                                    hedge_backend=self.hedge_backend, dispatch="async",
                                    device=device)
        self.engine.register(Variant(remote.name, remote.cfg, remote.params, remote.quality))
        median = mix["prompt_tokens"]["median"]
        steps = (mix["answer_tokens"]["min"] + mix["answer_tokens"]["max"]) // 2
        prof_seed = seed % (2**32)
        self.registry = self.engine.measure_profiles(
            prompt_len=median, gen_tokens=steps, trials=5, seed=prof_seed)
        self.ondevice = self.hedge_backend.measure_profile(
            prompt_len=median, gen_tokens=steps, trials=5, seed=prof_seed)
        self.scheduler = MDInferenceScheduler(
            self.registry, self.ondevice,
            SchedulerConfig(t_sla_ms=float(mix["sla_ms"]), seed=prof_seed))
        if spans is not None:
            _span_generate(self.backend, "generate.remote", spans)
            _span_generate(self.hedge_backend, "generate.hedge", spans)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, tuple) and tree and not all(isinstance(s, int) for s in tree):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    if isinstance(tree, tuple) and not tree:
        return {}
    return {path: tuple(tree)}


def _span_generate(backend, name: str, spans: Spans) -> None:
    """Record each ``generate`` call of ``backend`` as a host span."""
    inner = backend.generate

    def generate(*args, **kwargs):
        t0 = time.perf_counter_ns()
        try:
            return inner(*args, **kwargs)
        finally:
            spans.add(name, t0, time.perf_counter_ns())

    backend.generate = generate


def run_window(eng: Engine, stream: loadgen.Stream, seconds: float,
               spans: Optional[Spans] = None) -> WindowResult:
    """Serve ``stream`` open-loop; returns once every request is answered
    or the drain limit has passed."""
    from repro_torch.serving.lifecycle import QueuedRequest

    loop = eng.engine.make_loop(eng.scheduler)
    n = len(stream)
    futures: List = [None] * n
    lateness = np.zeros(n)
    ticks = []
    window_ms = stream.window_ms
    close_ms = seconds * 1e3
    limit_ms = close_ms + DRAIN_LIMIT_S * 1e3
    span = spans.add if spans is not None else (lambda *a: None)
    clock = time.perf_counter_ns
    t0 = clock()
    next_tick = window_ms
    i = 0
    while True:
        now = (clock() - t0) / 1e6
        if i < n and stream.due_ms[i] <= now:
            a = clock()
            while i < n and stream.due_ms[i] <= now:
                futures[i] = loop.submit(QueuedRequest(
                    rid=i, tokens=stream.prompts[i], n_steps=int(stream.n_steps[i]),
                    t_nw_est_ms=float(stream.nw_ms[i]), t_nw_actual_ms=float(stream.nw_ms[i]),
                    arrival_ms=float(stream.due_ms[i])))
                lateness[i] = now - stream.due_ms[i]
                i += 1
            span("submit", a, clock())
        if now >= next_tick:
            a = clock()
            loop.tick(now_ms=now, wait=False)
            span("tick", a, clock())
            while next_tick <= now:
                next_tick += window_ms
        a = clock()
        for result in loop.poll():
            ticks.append(result.stats)
        span("poll", a, clock())
        if i == n and all(f.done() for f in futures):
            break
        if now > limit_ms:
            break
        wake = next_tick if i == n else min(next_tick, stream.due_ms[i])
        pause = min(max(wake - (clock() - t0) / 1e6, 0.0), 2.0)
        if pause > 0:
            a = clock()
            time.sleep(pause / 1e3)
            span("idle", a, clock())
    t_end = clock()
    for result in loop.drain():  # nothing is left in flight once all are done
        ticks.append(result.stats)
    return _collect(eng, stream, futures, ticks, lateness, t0, t_end,
                    spans.items if spans is not None else [])


def _completion(f):
    from repro_torch.serving.lifecycle import RequestCancelled, RequestRejected

    if f is None or not f.done():
        return None
    try:
        return f.result(timeout=0)
    except (RequestCancelled, RequestRejected):
        return None


def _collect(eng, stream, futures, ticks, lateness, t0, t_end, spans) -> WindowResult:
    records, served = [], []
    for i, f in enumerate(futures):
        due_wall = t0 / 1e6 + stream.due_ms[i]
        c = _completion(f)
        done = {} if f is None else f.tier_done_wall_ms
        disp = {} if f is None else f.tier_dispatch_wall_ms
        remote_ms = done["remote"] - due_wall if "remote" in done else None
        answer = None
        if c is not None:
            tier = "remote" if c.used_remote else "ondevice"
            if tier in done:
                answer = done[tier] - due_wall + (stream.nw_ms[i] if c.used_remote else 0.0)
        records.append(Record(
            rid=i, prompt_len=len(stream.prompts[i]), n_steps=int(stream.n_steps[i]),
            answered=c is not None, used_remote=None if c is None else bool(c.used_remote),
            remote_ms=remote_ms, answer_ms=answer,
            queue_wait_ms=None if c is None else float(c.queue_wait_ms)))
        served.append(Served(
            rid=i, prompt=stream.prompts[i], n_steps=int(stream.n_steps[i]),
            tokens=None if c is None else np.asarray(c.tokens),
            used_remote=None if c is None else bool(c.used_remote),
            remote_batch=disp.get("remote"), hedge_batch=disp.get("ondevice")))
    return WindowResult(records=records, served=served, ticks=ticks, lateness_ms=lateness,
                        window_s=(t_end - t0) / 1e9, spans=spans)
