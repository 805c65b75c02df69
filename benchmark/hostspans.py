"""Host spans a traced run takes from the benchmark's own files, around
calls into the port: the time each engine thread spends inside an inbox
``put`` (blocked on a full downstream inbox, or enqueuing), so that a
stage's busy time can leave out the time it waited for the next stage."""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class PutTimer:
    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.seconds = defaultdict(float)    # thread name -> s in put
        self._mu = threading.Lock()
        self._saved = []

    def install(self):
        from windflow_tpu_torch.runtime import engine
        for cls in (engine.Inbox, engine.NativeInbox):
            orig = cls.put
            self._saved.append((cls, orig))
            cls.put = self._wrap(orig)

    def uninstall(self):
        for cls, orig in self._saved:
            cls.put = orig
        self._saved = []

    def _wrap(self, orig):
        timer = self

        def put(inbox, src, item):
            t = timer.clock()
            try:
                return orig(inbox, src, item)
            finally:
                dt = timer.clock() - t
                name = threading.current_thread().name
                with timer._mu:
                    timer.seconds[name] += dt
        return put
