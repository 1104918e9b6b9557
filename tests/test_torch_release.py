"""What a traced serve leaves behind, on the CPU.

A two-replica inline cluster with the measured hedge drains a traced async
trace (the shape of ``chip_smoke.py``'s tracing-cost runs, at reduced
width).  Afterwards no tensor is reachable from the ``Observability``
handle, attached or detached, and once the engine, loop and results are
dropped no tensor the run created stays alive: the port holds no device
memory past a drain.  (What ``chip_smoke.py`` still sees allocated on the
card after its releases is PyTorch's cache of cuBLAS workspaces, one per
cuBLAS handle and stream, which ``_release`` reports.)
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.network import LognormalNetwork  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.observability import Observability, request_conservation  # noqa: E402
from repro_torch.serving.loadgen import PoissonArrivals, make_trace  # noqa: E402
from repro_torch.serving.scheduler import MDInferenceScheduler, SchedulerConfig  # noqa: E402

N_REQ, PROMPT, GEN = 12, 8, 2


def _tensors(objs):
    return [o for o in objs if issubclass(type(o), torch.Tensor)]


def _reachable_tensors(root):
    """Tensors reachable from ``root`` through ``gc.get_referents`` (classes
    and modules not followed)."""
    seen, stack, found = set(), [root], []
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if issubclass(type(o), torch.Tensor):
            found.append(o)
            continue
        if isinstance(o, type) or type(o).__name__ == "module":
            continue
        stack.extend(gc.get_referents(o))
    return found


def _traced_drain():
    engine = serve.build_engine(PROMPT + GEN + 8, device="cpu", replicas=2, transport="inline",
                                dispatch="async")
    registry = engine.measure_profiles(prompt_len=PROMPT, gen_tokens=GEN, trials=1, seed=0)
    ondevice = engine.hedge_backend.measure_profile(prompt_len=PROMPT, gen_tokens=GEN, trials=1)
    obs = Observability()
    sched = MDInferenceScheduler(registry, ondevice, SchedulerConfig(t_sla_ms=2000.0, seed=0))
    loop = engine.make_loop(sched, dispatch="async", observability=obs)
    trace = make_trace(N_REQ, PoissonArrivals(40.0), LognormalNetwork(300.0, 0.6), seed=0)
    prompts = np.random.default_rng(0).integers(0, 256, (N_REQ, PROMPT))
    completions, _ = loop.drain_trace(trace, 200.0, tokens_for=lambda i: prompts[i],
                                      n_steps=GEN)
    audit = request_conservation(obs.tracer)
    assert audit["submitted"] == audit["resolved"] == len(completions) == N_REQ
    return engine, loop, obs, completions


def test_no_tensor_reachable_from_observability_after_a_traced_drain():
    engine, loop, obs, _ = _traced_drain()
    assert len(obs.tracer) > 0
    assert _reachable_tensors(obs) == []
    loop.attach_observability(None)
    assert _reachable_tensors(obs) == []
    del engine, loop


def test_a_released_traced_run_leaves_no_tensor_alive():
    gc.collect()
    before = {id(t) for t in _tensors(gc.get_objects())}
    engine, loop, obs, completions = _traced_drain()
    loop.attach_observability(None)
    del engine, loop, completions
    gc.collect()
    left = [t for t in _tensors(gc.get_objects()) if id(t) not in before]
    assert left == [], [tuple(t.shape) for t in left[:8]]
    assert _reachable_tensors(obs) == []
