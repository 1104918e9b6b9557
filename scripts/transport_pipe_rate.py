#!/usr/bin/env python3
"""Times how fast weight pieces cross the process transport's pipe.

    python3 scripts/transport_pipe_rate.py [--gb 8] [--seconds 60]

A spawned child receives pieces of ``transport.PIECE_BYTES`` from this
process over a ``multiprocessing`` duplex pipe, as a process worker
receives a variant's weights, until ``--gb`` have crossed or ``--seconds``
have passed, whichever comes first.  Three ways of moving the same bytes,
each in a fresh child:

* ``raw``: the transport's own ``send_raw`` / ``recv_raw_into`` (a length,
  then the bytes read straight into the child's buffer);
* ``raw+checksum``: the same with the parent's per-piece checksum
  (``transport._piece_sum``), as a registration computes it;
* ``connection``: ``Connection.send_bytes`` / ``Connection.recv_bytes_into``,
  which read each piece into an intermediate buffer first.

Host memory only: no torch in the child, no card.  Prints one JSON line
with each path's GB/s, the child's largest resident set, the host's CPU
count and, where ``nvidia-smi`` answers, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PATHS = ("raw", "raw+checksum", "connection")


def _child(conn, path: str, piece_bytes: int) -> None:
    from repro_torch.serving.transport_worker import recv_raw_into, sample_rss

    buf = bytearray(piece_bytes)
    got = pieces = 0
    t0 = None
    while True:
        n = conn.recv_bytes_into(buf) if path == "connection" else recv_raw_into(conn, buf)
        if t0 is None:
            t0 = time.perf_counter()  # timed from the end of the first piece
        if n == 0:
            break
        if pieces:
            got += n
        pieces += 1
        sample_rss()
    conn.send((got, time.perf_counter() - t0, pieces, sample_rss()))


def _run(path: str, gb: float, seconds: float, piece_bytes: int) -> dict:
    import numpy as np
    from repro_torch.serving.transport import _piece_sum
    from repro_torch.serving.transport_worker import send_raw

    src = np.full(piece_bytes, 7, dtype=np.uint8)
    ctx = mp.get_context("spawn")
    a, b = ctx.Pipe(duplex=True)
    proc = ctx.Process(target=_child, args=(b, path, piece_bytes), daemon=True)
    proc.start()
    b.close()
    sent = 0
    t0 = time.perf_counter()
    while sent < gb * 1e9 and time.perf_counter() - t0 < seconds:
        if path == "raw+checksum":
            _piece_sum(src)
        if path == "connection":
            a.send_bytes(src)
        else:
            send_raw(a, src)
        sent += piece_bytes
    if path == "connection":
        a.send_bytes(b"")
    else:
        send_raw(a, b"")
    got, child_s, pieces, rss_mib = a.recv()
    proc.join(30.0)
    return dict(path=path, gb=got / 1e9, seconds=child_s, pieces=pieces,
                gb_per_s=got / 1e9 / child_s if child_s > 0 else None,
                child_rss_mib=rss_mib)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "none"
    except (OSError, subprocess.SubprocessError):
        return "none"


def main(argv=None) -> int:
    from repro_torch.serving.transport import PIECE_BYTES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gb", type=float, default=8.0, help="bytes to send per path (GB)")
    ap.add_argument("--seconds", type=float, default=60.0, help="time limit per path")
    args = ap.parse_args(argv)
    rows = []
    for path in PATHS:
        row = _run(path, args.gb, args.seconds, PIECE_BYTES)
        print(f"[pipe] {row}", flush=True)
        rows.append(row)
    print(json.dumps(dict(piece_mib=PIECE_BYTES >> 20, cpus=os.cpu_count(), card=_card(),
                          rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
