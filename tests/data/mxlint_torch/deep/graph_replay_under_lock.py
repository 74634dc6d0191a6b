"""mxlint deep fixture (port idioms) — MXL202: a captured CUDA graph's
replay is a program dispatch, like a jitted one, and must not run under
a lock that guards fast paths."""
import threading

from mxtpu_torch import telemetry
from mxtpu_torch.cuda_graphs import capture_graph


class Stepper:
    def __init__(self, fn, warm, device):
        self._lock = threading.Lock()
        self._graph = capture_graph("step", fn, warm, device)
        self._decode = telemetry.watch(fn, "decode")
        self._steps = 0

    def step(self):
        with self._lock:
            self._steps += 1
            self._graph.replay()  # seeded: MXL202

    def decode(self, x):
        with self._lock:
            self._steps += 1
            return self._decode(x)  # seeded: MXL202

    def two_phase(self):
        with self._lock:
            self._steps += 1
        self._graph.replay()          # outside the lock: no finding

    def steps(self):
        with self._lock:
            return self._steps
