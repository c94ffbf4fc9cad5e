"""Seeded violation: a thread mutates state the step's hot path reads.

The lock makes every access consistent — and still loses: the step
reads ``self.scale`` once a call while the thread moves it, so two
workers of one step can see two values (thread the value as a step
argument instead)."""
import threading


class Stepper:
    def __init__(self):
        self.scale = 1.0
        self._lock = threading.Lock()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def step(self, x):  # dgclint: hot
        with self._lock:
            return x * self.scale

    def _run(self):
        while True:
            with self._lock:
                self.scale = self.scale * 0.5  # LINT: thread-traced-state
