"""Process-worker entry point for :mod:`repro_torch.serving.transport`.

Lives in its own module so a spawned child imports *only* this file plus
whatever the pickled backend factory pulls in — a stub factory keeps the
child free of torch, which is what makes process-transport tests cheap
enough for the CPU test run.  At module level this file imports the
standard library only; torch is imported inside the one handler that
places tensors (:func:`_receive_pieces`).

Protocol (one duplex :class:`multiprocessing.connection.Connection`):

parent → child messages (tuples, first element is the op):

* ``("register", seq, variant)`` — register a variant without tensors (a
  stub's) on the child backend; acknowledged with
  ``("registered", seq, info)``.
* ``("register_pieces", seq, variant, specs, piece_bytes)`` — a variant
  whose parameters are tensors.  ``variant.params`` is the tree with every
  leaf ``None``; ``specs`` is ``(shape, dtype)`` per leaf in tree order,
  and the leaves' bytes follow as raw pieces of at most ``piece_bytes``
  each, leaf after leaf (:func:`send_raw` / :func:`recv_raw_into`: an
  8-byte length, then the bytes, read straight into the worker's staging
  buffer, without the intermediate buffer ``recv_bytes_into`` fills).  The child places each piece on
  its backend's device as it arrives (host memory: one piece), then
  registers and acknowledges with ``("registered", seq, info)``:
  ``info["checksums"]`` is, per leaf, the sum of the placed bytes read as
  integer words (see :func:`word_sum_bytes`), which the parent checks
  against its own copy; ``info["rss"]`` is the worker's resident set (MiB)
  at entry, before the first piece, the largest while pieces arrive and
  after the last.
* ``("submit", seq, name, batch, n_steps)`` — run one batch.
* ``("submit", seq, name, batch, n_steps, True)`` — run one batch *and*
  report worker-side timings (the tracing-enabled submit).
* ``("stats", seq)`` — report the worker's pid, peak host RSS, device
  memory and kernel launch counts: ``("stats", seq, info)``.
* ``("stop",)`` — exit the loop.

child → parent messages:

* ``("result", seq, out, wall_ms)`` — batch ``seq`` finished.
* ``("result", seq, out, wall_ms, span_info)`` — traced completion;
  ``span_info`` is ``{"handle_ms", "wall_ms"}`` — *relative* durations
  (total submit-handling and the timed execution), because the child's
  ``perf_counter`` epoch is meaningless to the parent.  The parent
  anchors the reconstructed ``worker.execute`` span at its own receive
  stamp.
* ``("registered", seq, info)`` / ``("stats", seq, info)`` — the replies
  above.
* ``("error", seq, repr_str)`` — batch or registration ``seq`` raised;
  the exception is flattened to its ``repr`` (arbitrary exceptions may not
  pickle).  ``seq == -1``: the backend could not be built (for example a
  worker asked for ``cuda`` on a machine without a GPU); the child exits.

The child never shares memory with the parent: every batch crosses the
pipe as a pickled ndarray and every parameter as raw bytes — never as a
torch tensor, whose pickling would map the parent's CUDA or shared host
memory into the child.
"""
from __future__ import annotations

import dataclasses
import os
import resource
import struct
import sys
import time

_RAW_HEADER = struct.Struct("!Q")  # a raw piece's length, before its bytes


def word_sum_bytes(n: int) -> int:
    """The word size (bytes) a piece of ``n`` bytes is summed in: 4 when
    ``n`` is a multiple of 4, else 2 when even, else 1.  Both sides of the
    transport sum the same pieces the same way."""
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def send_raw(conn, buf) -> None:
    """Write one raw piece (length, then bytes) on ``conn``'s descriptor."""
    view = memoryview(buf).cast("B")
    fd = conn.fileno()
    _write_all(fd, _RAW_HEADER.pack(len(view)))
    _write_all(fd, view)


def _write_all(fd, view) -> None:
    view = memoryview(view)
    while len(view):
        view = view[os.write(fd, view):]


def recv_raw_into(conn, buf) -> int:
    """Read one raw piece from ``conn``'s descriptor into ``buf``; returns
    its length (``ValueError`` if it does not fit)."""
    fd = conn.fileno()
    header = bytearray(_RAW_HEADER.size)
    _read_all(fd, memoryview(header))
    (n,) = _RAW_HEADER.unpack(header)
    view = memoryview(buf).cast("B")
    if n > len(view):
        raise ValueError(f"raw piece of {n} bytes exceeds the {len(view)}-byte buffer")
    _read_all(fd, view[:n])
    return n


def _read_all(fd, view) -> None:
    got = 0
    while got < len(view):
        k = os.readv(fd, [view[got:]])
        if k == 0:
            raise EOFError("pipe closed mid-piece")
        got += k


def _status_kib(field: str):
    """A ``kB`` field of ``/proc/self/status`` (``None`` where absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


_SAMPLED_PEAK_KIB = 0  # the largest VmRSS seen at the sampling points


def sample_rss() -> float:
    """Fold the current resident set into the sampled peak (called after
    every weight piece and every batch); returns it in MiB (NaN where the
    kernel does not report it)."""
    global _SAMPLED_PEAK_KIB
    now = _status_kib("VmRSS")
    if now is None:
        return float("nan")
    _SAMPLED_PEAK_KIB = max(_SAMPLED_PEAK_KIB, now)
    return now / 1024.0


def peak_rss() -> tuple:
    """``(MiB, source)``: this process's peak resident set.  ``VmHWM``
    starts anew at ``exec``; where the kernel does not report it, the
    largest ``VmRSS`` sampled by :func:`sample_rss`; failing both,
    ``ru_maxrss``, which a spawned child inherits from the parent it was
    forked from (an upper bound only)."""
    sample_rss()
    hwm = _status_kib("VmHWM")
    if hwm is not None:
        return hwm / 1024.0, "VmHWM"
    if _SAMPLED_PEAK_KIB:
        return _SAMPLED_PEAK_KIB / 1024.0, "sampled VmRSS"
    return (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0,
            "ru_maxrss (inherited at spawn)")


def _stats(backend) -> dict:
    """The worker's pid, peak host RSS, whether torch / jax were ever
    imported here and (if the backend is on a card) its device memory."""
    peak, source = peak_rss()
    info = {"pid": os.getpid(), "peak_rss_mib": peak, "rss_source": source,
            "sampled_peak_rss_mib": _SAMPLED_PEAK_KIB / 1024.0,
            "torch_loaded": "torch" in sys.modules, "jax_loaded": "jax" in sys.modules}
    torch = sys.modules.get("torch")
    device = getattr(backend, "device", None)
    if torch is not None and getattr(device, "type", None) == "cuda":
        info["device_allocated_gib"] = torch.cuda.memory_allocated(device) / 2**30
        info["device_peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
        free, total = torch.cuda.mem_get_info(device)
        info["device_free_gib"] = free / 2**30
        info["device_total_gib"] = total / 2**30
    ops = sys.modules.get("repro_torch.kernels.ops")
    if ops is not None:  # the kernels this worker launched since it started
        info["launch_counts"] = ops.launch_counts()
    return info


def _n_pieces(specs, piece_bytes: int, itemsize) -> int:
    return sum(-(-_numel(shape) * itemsize(dtype) // piece_bytes) for shape, dtype in specs)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _receive_pieces(conn, backend, variant, specs, piece_bytes) -> dict:
    """Receive a tensor variant's leaves piece by piece onto the backend's
    device, register it, and return the acknowledgement's info.  If placing
    fails, the remaining pieces are still read off the pipe (so the next
    message is a message) before the error propagates."""
    import torch

    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    # Resident set at entry, once the staging buffer (and, on a card, the
    # CUDA context) exists, the largest while pieces arrive, and at the end:
    # what the pieces cost apart from the process's start-up.
    rss = {"entry_mib": sample_rss()}
    expected = _n_pieces(specs, piece_bytes,
                         lambda dt: torch.empty((), dtype=dt).element_size())
    received = 0
    try:
        device = torch.device(getattr(backend, "device", "cpu"))
        staging = torch.empty(piece_bytes, dtype=torch.uint8,
                              pin_memory=device.type == "cuda")
        view = staging.numpy()
        word = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
        leaves, checksums, total = [], [], 0
        rss["before_pieces_mib"] = rss["pieces_peak_mib"] = sample_rss()
        for shape, dtype in specs:
            leaf = torch.empty(shape, dtype=dtype, device=device)
            flat = leaf.view(-1).view(torch.uint8)
            nbytes, acc = flat.numel(), 0
            for off in range(0, nbytes, piece_bytes):
                n = recv_raw_into(conn, view)
                received += 1
                want = min(piece_bytes, nbytes - off)
                if n != want:
                    raise ValueError(f"piece of {n} bytes, expected {want}")
                dst = flat[off:off + n]
                dst.copy_(staging[:n])
                acc += int(dst.view(word[word_sum_bytes(n)]).sum(dtype=torch.int64))
                rss["pieces_peak_mib"] = max(rss["pieces_peak_mib"], sample_rss())
            leaves.append(leaf)
            checksums.append(acc)
            total += nbytes
        it = iter(leaves)
        params = tree_map(lambda _: next(it), variant.params)
        backend.register(dataclasses.replace(variant, params=params))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rss["after_pieces_mib"] = sample_rss()
    except (EOFError, OSError):
        raise
    except BaseException:
        scratch = bytearray(piece_bytes)
        for _ in range(expected - received):
            recv_raw_into(conn, scratch)
        raise
    info = _stats(backend)
    info.update(checksums=checksums, bytes=total, seconds=time.perf_counter() - t0,
                rss=rss)
    return info


def worker_main(conn, factory) -> None:
    """Run a backend worker: build the backend, serve the message loop."""
    try:
        backend = factory()
    except BaseException as e:  # surface construction failure, then die
        try:
            conn.send(("error", -1, f"worker backend construction: {e!r}"))
        finally:
            conn.close()
        return
    try:
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "stop":
                break
            if op in ("register", "register_pieces"):
                seq = msg[1]
                try:
                    if op == "register":
                        t0 = time.perf_counter()
                        backend.register(msg[2])
                        info = _stats(backend)
                        info.update(checksums=None, bytes=0,
                                    seconds=time.perf_counter() - t0)
                    else:
                        info = _receive_pieces(conn, backend, *msg[2:5])
                except (EOFError, OSError):
                    raise
                except Exception as e:  # the worker survives a failed registration
                    conn.send(("error", seq, repr(e)))
                    continue
                conn.send(("registered", seq, info))
                continue
            if op == "stats":
                conn.send(("stats", msg[1], _stats(backend)))
                continue
            if op == "submit":
                seq, name, batch, n_steps = msg[1], msg[2], msg[3], msg[4]
                traced = len(msg) > 5 and bool(msg[5])
                try:
                    t0 = time.perf_counter()
                    out, wall_ms = backend.run_batch(name, batch, n_steps)
                    sample_rss()
                    if traced:
                        handle_ms = (time.perf_counter() - t0) * 1e3
                        span_info = {
                            "handle_ms": handle_ms,
                            "wall_ms": float(wall_ms),
                        }
                        conn.send(
                            ("result", seq, out, float(wall_ms), span_info)
                        )
                    else:
                        conn.send(("result", seq, out, float(wall_ms)))
                except BaseException as e:
                    conn.send(("error", seq, repr(e)))
                continue
            raise ValueError(f"unknown transport op {op!r}")
    except (EOFError, OSError):
        pass  # parent went away: nothing left to serve
    finally:
        conn.close()
