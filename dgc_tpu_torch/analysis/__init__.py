"""The port's analysis layer: lints, contracts, verifier, protocols.

Counterpart of ``dgc_tpu/analysis/``, one CLI gate (``python -m
dgc_tpu_torch.analysis``):

* **Layer 1 — AST lints** (:mod:`~dgc_tpu_torch.analysis.astlint`,
  :mod:`~dgc_tpu_torch.analysis.rules`): DGC101-103, 106 and 107 over the
  package source, the step's hot path inferred from declared roots. Pure
  AST work: no torch import, milliseconds.
* **Layer 2 — contracts** (:mod:`~dgc_tpu_torch.analysis.program`,
  :mod:`~dgc_tpu_torch.analysis.contracts`,
  :mod:`~dgc_tpu_torch.analysis.suite`): expectations over recorded
  steps — collective counts through a recording ``Comm``, op-trace
  identity, the code a step ran, state kept in place, build guards —
  and the standing 33-contract suite.
* **Layer 3 — verifier** (:mod:`~dgc_tpu_torch.analysis.verify`): four
  taint passes over a step's dispatch trace (collective axes, dtype
  flow, donation/liveness with ``runs/analysis_report.json``,
  error-feedback conservation) and the runtime conservation check.
* **Layer 4 — protocols** (:mod:`~dgc_tpu_torch.analysis.protospec`,
  :mod:`~dgc_tpu_torch.analysis.mc`,
  :mod:`~dgc_tpu_torch.analysis.racelint`): the crash-consistency model
  checker over the port's file writers and the DGC201-204 race lint.

Audited exceptions live in ``analysis/allowlist.toml`` (a one-line reason
each) or inline ``# dgclint: ok[rule]`` / ``# dgcver: ok[pass]``
markers.
"""

from dgc_tpu_torch.analysis.rules import (RULES, VERIFY_PASSES,  # noqa: F401
                                          Allowlist, Finding)

__all__ = ["RULES", "VERIFY_PASSES", "Allowlist", "Finding", "lint_paths",
           "Contract", "ContractViolation", "BuildGuard", "AxisPolicy",
           "run_verify_suite", "RecordingComm", "Recorder"]


def lint_paths(*args, **kwargs):
    """Lazy alias for :func:`dgc_tpu_torch.analysis.astlint.lint_paths`."""
    from dgc_tpu_torch.analysis.astlint import lint_paths as _lint
    return _lint(*args, **kwargs)


def __getattr__(name):
    # the recorded layers import torch — keep the AST layer import-light
    if name in ("Contract", "ContractViolation", "BuildGuard"):
        from dgc_tpu_torch.analysis import contracts
        return getattr(contracts, name)
    if name in ("AxisPolicy", "run_verify_suite"):
        from dgc_tpu_torch.analysis import verify
        return getattr(verify, name)
    if name in ("RecordingComm", "Recorder"):
        from dgc_tpu_torch.analysis import program
        return getattr(program, name)
    raise AttributeError(name)
