"""Fault tolerance for the DGC training loop (counterpart of
``dgc_tpu/resilience``): step guards (:mod:`guard`), the exchange's
integrity (:mod:`integrity`), fault injection (:mod:`faults`), preemption
and the watchdog (:mod:`preempt`) and the elastic restart across a world
size change (:mod:`elastic`). Not ported: the straggler-adaptive
exchange (``adaptive.py``, waits for the fleet telemetry lanes, ROADMAP.md
queue 1 item 9) and cohort surgery (``surgery.py``, waits for the serving
protocol, item 10)."""
