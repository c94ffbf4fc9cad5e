"""CLI gate: ``python -m dgc_tpu_torch.analysis [paths...] [options]``.

Modes
-----
default / ``--lint``   AST lints only (milliseconds, no device).
``--contracts``        the recorded-step contract suite (``--device``).
``--verify``           the four verifier passes (``--device``; ``--fast``
                       skips the donation pass and the report).
``--race``             the host-concurrency lints DGC201-204 (no device).
``--mc``               the crash-consistency model checker over the file
                       protocols (implies ``--race``; no device;
                       ``DGC_MC_MUTATE`` seeds a bug that must turn it
                       red).
``--gate``             lints + contracts.

``--device`` defaults to ``cuda`` and raises without a card unless
``--device cpu`` is given. The taint passes (DGCV02, DGCV04) read a
dispatch trace, to which the card's ctypes kernels are opaque, so they
always trace the step on the CPU with the kernels' plain versions (the
report says which part ran where); with ``--device cuda`` the contracts,
the donation pass and the runtime conservation check run on the card.

Exit codes: 0 clean, 1 violations (un-allowlisted lint or race findings,
a failed contract, an un-waived verifier finding, a model-checker
protocol violation), 2 usage/internal error.
"""

import argparse
import json
import sys


def _print_findings(tool, findings, as_json, show_allowed) -> bool:
    bad = [f for f in findings if not f.allowed]
    if as_json:
        print(json.dumps([vars(f) for f in findings], indent=2))
    else:
        for f in (findings if show_allowed else bad):
            print(f.format())
        print(f"{tool}: {len(bad)} violation(s), "
              f"{sum(f.allowed for f in findings)} allowlisted")
    return bool(bad)


def _print_results(tag, results):
    failed = [(n, v) for n, v in results if v]
    for name, violations in failed:
        print(f"{tag} FAIL {name}")
        for v in violations:
            print(f"  - {v}")
    return bool(failed), f"{len(results) - len(failed)}/{len(results)} ok"


def main(argv=None) -> int:
    from dgc_tpu_torch.analysis.astlint import DEFAULT_ROOTS, lint_paths
    from dgc_tpu_torch.analysis.rules import load_allowlist

    ap = argparse.ArgumentParser(
        prog="python -m dgc_tpu_torch.analysis",
        description="the port's lints, contracts, verifier and protocol "
                    "checks",
        epilog="The taint passes (DGCV02 dtype-flow, DGCV04 "
               "ef-conservation) read a dispatch trace, to which the "
               "card's ctypes kernels are opaque: they trace the step on "
               "the CPU with the kernels' plain versions, whatever "
               "--device says, and the report records which part ran on "
               "which device.")
    ap.add_argument("paths", nargs="*", default=None,
                    help=f"files/dirs to lint (default: {DEFAULT_ROOTS})")
    ap.add_argument("--lint", action="store_true",
                    help="AST lints only (the default mode)")
    ap.add_argument("--contracts", action="store_true",
                    help="the recorded-step contract suite")
    ap.add_argument("--gate", action="store_true",
                    help="lints + contracts")
    ap.add_argument("--verify", action="store_true",
                    help="the verifier passes (collective-axis, "
                         "dtype-flow, donation-liveness, ef-conservation)")
    ap.add_argument("--race", action="store_true",
                    help="host-concurrency lints DGC201-204")
    ap.add_argument("--mc", action="store_true",
                    help="crash-consistency model checker over the file "
                         "protocols (implies --race)")
    ap.add_argument("--fast", action="store_true",
                    help="with --verify: skip the donation pass and the "
                         "report; with --mc: skip the checkpoint scenario")
    ap.add_argument("--device", default="cuda",
                    help="where --contracts and --verify run their steps "
                         "(default cuda; raises without a card unless "
                         "--device cpu)")
    ap.add_argument("--allowlist", default=None, metavar="TOML",
                    help="override analysis/allowlist.toml")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable lint findings")
    ap.add_argument("--show-allowed", action="store_true",
                    help="also print allowlisted findings")
    ap.add_argument("--root", default=None,
                    help="repo root to lint relative to (default: cwd)")
    args = ap.parse_args(argv)

    do_contracts = args.contracts or args.gate
    do_race = args.race or args.mc
    do_lint = args.lint or args.gate or not (
        args.contracts or args.verify or do_race)
    try:
        allowlist = load_allowlist(args.allowlist)
    except ValueError as e:
        print(f"dgclint: bad allowlist: {e}", file=sys.stderr)
        return 2
    device = None
    if do_contracts or args.verify:
        from dgc_tpu_torch.utils.device import resolve_device
        device = resolve_device(args.device).type
    rc = 0

    if do_lint:
        findings = lint_paths(args.paths or DEFAULT_ROOTS,
                              allowlist=allowlist, root=args.root)
        if _print_findings("dgclint", findings, args.as_json,
                           args.show_allowed):
            rc = 1

    if do_contracts:
        from dgc_tpu_torch.analysis.suite import run_contract_suite
        bad, summary = _print_results("CONTRACT", run_contract_suite(
            log=lambda s: print(f"dgclint: {s}"), device=device))
        print(f"dgclint: contracts on {device} {summary}")
        rc = rc or int(bad)

    if do_race:
        from dgc_tpu_torch.analysis.racelint import race_lint_paths
        rfindings = race_lint_paths(args.paths or DEFAULT_ROOTS,
                                    allowlist=allowlist, root=args.root)
        if _print_findings("dgcrace", rfindings, args.as_json,
                           args.show_allowed):
            rc = 1

    if args.mc:
        from dgc_tpu_torch.analysis.mc import run_mc_suite
        bad, summary = _print_results("MC", run_mc_suite(
            log=lambda s: print(f"dgcmc: {s}"), fast=args.fast))
        print(f"dgcmc: protocols {summary}")
        rc = rc or int(bad)

    if args.verify:
        from dgc_tpu_torch.analysis.verify import run_verify_suite
        bad, summary = _print_results("VERIFY", run_verify_suite(
            log=lambda s: print(f"dgcver: {s}"), root=args.root,
            fast=args.fast, allowlist=allowlist, device=device))
        print(f"dgcver: passes {summary}")
        rc = rc or int(bad)
    return rc


if __name__ == "__main__":
    sys.exit(main())
