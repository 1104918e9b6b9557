"""The stream set behind ``JitBackend.generate`` (serving/backend.py).

PyTorch keeps a cuBLAS workspace per (cuBLAS handle, stream) for the life
of the process; a fresh stream per call, on the fresh handle of each async
worker thread, grew that cache to 5 GiB on the card.  Each device now has
one :class:`StreamSet`: a stream is made, with one worker thread that runs
its calls one at a time, only when a call finds every worker busy, so the
set grows to the most calls in flight at once and no call waits.

On the CPU the bookkeeping runs on stand-in stream objects under threads;
the ``cuda``-marked test runs real concurrent ``generate`` calls on a card.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.archs import reduced  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import backend  # noqa: E402


def _in_flight_together(streams, n, rounds=1):
    """``rounds`` times, ``n`` calls from ``n`` fresh threads that can only
    finish once all ``n`` run at once (a call left waiting for a stream
    breaks the barrier).  Returns the streams each call ran on and the
    threads that ran each stream."""
    barrier, lock = threading.Barrier(n, timeout=10), threading.Lock()
    holders, threads_of, errors = {}, {}, []

    def call(i):
        def fn(s):
            with lock:
                assert s not in holders.values(), "a stream was given to two calls at once"
                holders[i] = s
                threads_of.setdefault(id(s), set()).add(threading.get_ident())
            barrier.wait()
            with lock:
                del holders[i]
            return i

        try:
            assert streams.run(fn) == i
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    for _ in range(rounds):
        callers = [threading.Thread(target=call, args=(i,)) for i in range(n)]
        for t in callers:
            t.start()
        for t in callers:
            t.join()
    assert not errors, errors
    return threads_of


def test_stream_set_grows_to_the_calls_in_flight_and_runs_each_alone():
    made = []

    def make():
        made.append(object())
        return made[-1]

    streams = backend.StreamSet(make)
    assert streams.size == 0 and not made  # nothing before the first call
    threads_of = _in_flight_together(streams, 3, rounds=4)
    assert len(made) == streams.size == 3 and streams.idle() == 3
    # Each stream is served by one thread, whatever thread the call came from.
    assert len(threads_of) == 3 and all(len(t) == 1 for t in threads_of.values())
    for i in range(5):  # one call at a time takes an idle stream
        assert streams.run(lambda s, i=i: i) == i
    assert streams.size == 3


def test_a_tick_of_three_tiers_hedge_and_degrade_waits_for_no_stream():
    """One tick sends a batch per tier chunk (tier-s, tier-m, tier-l), the
    hedge and the degrade batch at once, and a second tick can be in flight
    before the first drains: ten concurrent calls, none of them waiting."""
    streams = backend.StreamSet(object)
    _in_flight_together(streams, 5)
    assert streams.size == 5
    _in_flight_together(streams, 10)
    assert streams.size == 10 and streams.idle() == 10
    _in_flight_together(streams, 5, rounds=3)
    assert streams.size == 10  # the set does not grow past its peak


def test_stream_set_raises_a_calls_error_in_the_caller():
    streams = backend.StreamSet(object)

    def fail(_):
        raise RuntimeError("batch failed")

    with pytest.raises(RuntimeError, match="batch failed"):
        streams.run(fail)
    assert streams.run(lambda s: s) is streams.streams[0] and streams.idle() == 1


def test_cpu_generate_takes_no_stream(monkeypatch):
    monkeypatch.setattr(backend, "device_streams",
                        lambda *_: pytest.fail("a CPU generate asked for CUDA streams"))
    cfg = reduced("gemma-2b", n_layers=2)
    jb = backend.JitBackend(max_len=16, device="cpu")
    jb.register(backend.Variant("v", cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                                                        "cpu"), 1.0))
    out, wall = jb.generate("v", np.zeros((2, 4), np.int64), 3)
    assert out.shape == (2, 3) and wall > 0


@pytest.mark.cuda
def test_concurrent_generates_stay_on_the_device_stream_set():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = reduced("gemma-2b", n_layers=2)
    jb = backend.JitBackend(max_len=16, device="cuda")
    jb.register(backend.Variant("v", cfg, T.init_params(cfg, torch.Generator().manual_seed(0),
                                                        "cuda"), 1.0))
    tokens = np.arange(8).reshape(2, 4) % cfg.vocab_size
    want, _ = jb.generate("v", tokens, 4)
    streams = backend.device_streams(torch.device("cuda"))
    results = []
    for _ in range(3):  # fresh threads each round, as async dispatch makes them
        threads = [threading.Thread(target=lambda: results.append(jb.generate("v", tokens, 4)[0]))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert all(np.array_equal(r, want) for r in results)
    assert streams.idle() == streams.size <= 8 + 1
    assert {s for _, s in streams.pairs} <= {s.cuda_stream for s in streams.streams}
    # One cuBLAS handle per stream: its worker thread's.
    assert len(streams.pairs) == len({h for h, _ in streams.pairs}) <= streams.size


def test_stream_set_keeps_nothing_of_a_finished_call():
    """A worker waiting for its next call holds no reference to the last
    one's closure or result (a backend's weights would stay allocated)."""
    import gc
    import weakref

    class Payload:
        pass

    streams = backend.StreamSet(object)
    payload = Payload()
    ref = weakref.ref(payload)
    assert streams.run(lambda s, p=payload: p) is payload
    del payload
    gc.collect()
    assert ref() is None
