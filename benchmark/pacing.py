"""The one load generator: it reads a traffic mix (``traffic/<mix>.json``)
and paces a system's chunks by it.

A mix is ``{"loop": "closed", "chunk": n}``: chunks of n records as fast
as the pipeline takes them (the source blocks on its bounded inbox), for
the window's seconds; or ``{"loop": "open", "chunk": n, "rate": r}``:
chunk c is due ``c * n / r`` seconds after the window opens, whatever the
pipeline does, for as many chunks as fall due inside the window.  Each
chunk's due time, and how late it went out, is kept; a record is timed
from when it was due.
"""

from __future__ import annotations

import math
import threading
import time

LOOPS = ("closed", "open")


def check_mix(mix: dict) -> dict:
    """Refuse a mix this generator cannot run."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop must be one of {LOOPS}: {mix}")
    if not (isinstance(mix.get("chunk"), int) and mix["chunk"] > 0):
        raise ValueError(f"traffic chunk must be a positive integer: {mix}")
    if mix["loop"] == "open" and not mix.get("rate", 0) > 0:
        raise ValueError(f"an open loop needs a positive rate: {mix}")
    return mix


class Paced:
    """Iterable of chunks ``make_chunk(c, t)`` (t: seconds since the
    window opened at which chunk c was made, or was due in an open
    loop).  The window opens at the first chunk."""

    def __init__(self, mix: dict, make_chunk, seconds: float,
                 clock=time.perf_counter, sleep=time.sleep):
        self.mix = check_mix(mix)
        self.make_chunk = make_chunk
        self.seconds = float(seconds)
        self.clock, self.sleep = clock, sleep
        self.t0 = None
        self.due = []          # per chunk: seconds after t0 it was due
        self.sent = []         # per chunk: seconds after t0 it went out
        self.records = 0
        self.make_s = 0.0      # time spent making chunks
        self.outside_s = 0.0   # time the consumer held each chunk
        self.thread = None     # the thread that iterates

    def _made(self, c, t):
        t_in = self.clock()
        b = self.make_chunk(c, t)
        self.make_s += self.clock() - t_in
        return b

    def __iter__(self):
        for b in self._chunks():
            t = self.clock()
            yield b
            self.outside_s += self.clock() - t

    def _chunks(self):
        self.thread = threading.current_thread().name
        clock = self.clock
        self.t0 = t0 = clock()
        c = 0
        if self.mix["loop"] == "closed":
            while True:
                t = clock() - t0
                if t >= self.seconds:
                    return
                b = self._made(c, t)
                self.due.append(t)
                self.sent.append(clock() - t0)
                self.records += len(b)
                yield b
                c += 1
        period = self.mix["chunk"] / self.mix["rate"]
        n = n_open_chunks(self.mix, self.seconds)
        for c in range(n):
            due = c * period
            b = self._made(c, due)
            wait = due - (clock() - t0)
            if wait > 0:
                self.sleep(wait)
            self.due.append(due)
            self.sent.append(clock() - t0)
            self.records += len(b)
            yield b


def n_open_chunks(mix: dict, seconds: float) -> int:
    """Chunks an open loop sends in a window: those due before it ends."""
    return max(1, math.ceil(float(seconds) * mix["rate"] / mix["chunk"]
                            - 1e-9))
