"""Batches of a FASTA/FASTQ file, parsed on a reader thread.

The read stage of the reference's 3-stage pipeline (kt_pipeline,
src/lib/kthread.c:157-197): a reader thread parses batch N+1 while the
caller classifies batch N. A queue of two bounds what is read ahead, and a
read error is raised to the caller in its place in the stream, after the
batches before it. Closing the generator early stops the reader thread
before the close returns.
"""
from __future__ import annotations

import queue
import threading

from .fastx import read_fastx_fast as read_fastx

_END = object()


def prefetch_batches(path, max_reads, max_bp=None):
    """Yield lists of the records of ``path`` in file order, each of at
    most ``max_reads`` records, and closed early once it holds ``max_bp``
    bases or more (no base limit if None)."""
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item):
        # give up once the consumer has gone, so the thread can end
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def reader():
        batch, bp = [], 0
        try:
            for rec in read_fastx(path):
                batch.append(rec)
                bp += len(rec.seq)
                if len(batch) >= max_reads or (max_bp is not None
                                               and bp >= max_bp):
                    if not put(batch):
                        return
                    batch, bp = [], 0
            if batch and not put(batch):
                return
            put(_END)
        except BaseException as e:   # raised to the caller, in order
            put(e)

    t = threading.Thread(target=reader, name="desamba-reader", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
