"""Fault tolerance for the DGC training loop (counterpart of
``dgc_tpu/resilience``): step guards (:mod:`guard`), the exchange's
integrity (:mod:`integrity`), fault injection (:mod:`faults`), preemption
and the watchdog (:mod:`preempt`), the elastic restart across a world
size change (:mod:`elastic`) and the straggler-adaptive exchange
(:mod:`adaptive`: a policy on the fleet telemetry's ``w_clock`` lane
shrinks a lagging worker's send fraction; the withheld mass stays in its
residual) and cohort surgery (:mod:`surgery`: an excise order folded into
the step-boundary agreement, with a deadline, and exit 76)."""
