"""The producer / writer overlap of the bulk EC loops: the encode and the
RS rebuild of encoder.py, the Clay single-loss rebuild and the LRC rebuild
of codes.py."""

from __future__ import annotations

import contextlib
import queue as _queue
import threading

from ...ops.codec import current_job, job, stage

# Batches in flight between the reading/submitting producer and the
# shard-file writer thread.  2 = classic double buffering: while the device
# encodes batch N and the writer drains N-1, the producer reads N+1 from
# disk.
PIPELINE_DEPTH = 2


def _pipelined(produce, consume, backend: str, op: str) -> None:
    """Run `produce` (a generator issuing async device work per item) against
    `consume(item)` on a writer thread, PIPELINE_DEPTH items in flight.

    The producer runs on the calling thread: it reads the next window from
    disk and submits its codec call while the device chews the previous one
    and the writer blocks in fetch()/file-writes.  A bounded queue keeps at
    most PIPELINE_DEPTH batches of host buffers alive, and writes happen in
    submission order (single consumer, FIFO queue), which append-only shard
    files require.  Each put, and the end of the stream with the writer's
    drain, is an ec_queue_wait stage under (backend, op); the writer thread
    takes the caller's job."""
    q: _queue.Queue = _queue.Queue(maxsize=PIPELINE_DEPTH)
    errs: list[BaseException] = []
    outer = current_job()

    def writer():
        with job(*outer) if outer else contextlib.nullcontext():
            while True:
                item = q.get()
                if item is None:
                    return
                if not errs:
                    try:
                        consume(item)
                    except BaseException as e:  # surfaced to the caller
                        errs.append(e)
                # after an error keep draining so the producer never
                # deadlocks on a full queue

    t = threading.Thread(target=writer, name="ec-writer")
    t.start()
    try:
        for item in produce:
            if errs:
                break
            with stage("ec_queue_wait", backend, op):
                q.put(item)
    finally:
        with stage("ec_queue_wait", backend, op):
            q.put(None)
            t.join()
    if errs:
        raise errs[0]
