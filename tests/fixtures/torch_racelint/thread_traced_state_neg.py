"""Clean twin: the mutable value rides the step as an ARGUMENT, read once
by the driver before the step."""
import threading


class Stepper:
    def __init__(self):
        self.scale = 1.0
        self._lock = threading.Lock()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def step(self, x, scale):  # dgclint: hot
        return x * scale

    def snapshot(self):
        with self._lock:
            return self.scale

    def _run(self):
        while True:
            with self._lock:
                self.scale = self.scale * 0.5
