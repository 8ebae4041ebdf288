"""CLI: ``python -m langstream_tpu_torch.analysis [--strict] [--only PASS]
[--root ROOT] [--json] [--list]``.

Exit codes: 0 clean (after suppressions + baseline), 1 findings (or, in
--strict mode, stale baseline entries), 2 usage/internal error. The
whole-tree-clean test in tests/test_torch_analysis.py runs the same entry,
so drift in the port fails tier-1.
"""

from __future__ import annotations

import argparse
import json
import sys

from langstream_tpu_torch.analysis.core import (
    BASELINE_FILE,
    all_checkers,
    apply_baseline,
    load_baseline,
    repo_root_from_here,
    run_checks,
    summarize,
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m langstream_tpu_torch.analysis",
        description="lstpu-check on the PyTorch port's tree "
        "(langstream_tpu_torch/)",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="also fail on stale baseline entries (the CI mode)",
    )
    parser.add_argument(
        "--only",
        action="append",
        metavar="PASS",
        help="run a single pass (repeatable; compile_surface and "
        "compile-surface are one pass); default: all",
    )
    parser.add_argument(
        "--root",
        default=None,
        help="repo root (default: derived from the package location)",
    )
    parser.add_argument(
        "--json",
        action="store_true",
        help="machine-readable findings on stdout",
    )
    parser.add_argument(
        "--list",
        action="store_true",
        help="list the registered passes and exit",
    )
    args = parser.parse_args(argv)

    if args.list:
        for name in all_checkers():
            print(name)
        return 0

    root = args.root or repo_root_from_here()
    try:
        repo, findings = run_checks(root, only=args.only)
        baseline = load_baseline(root)
        findings, stale = apply_baseline(findings, baseline)
    except RuntimeError as e:
        print(f"lstpu-check: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(
            json.dumps(
                {
                    "findings": [f.__dict__ for f in findings],
                    "stale_baseline": stale,
                    "summary": summarize(findings),
                },
                indent=1,
            )
        )
    else:
        for f in findings:
            print(f.render())
        if stale:
            for key, n in sorted(stale.items()):
                print(
                    f"stale baseline entry {key} ({n} unused)",
                    file=sys.stderr,
                )
    if findings:
        s = summarize(findings)
        print(
            f"lstpu-check: {s['total']} finding(s) "
            + " ".join(
                f"{c}={n}" for c, n in sorted(s["by_code"].items())
            ),
            file=sys.stderr,
        )
        return 1
    if args.strict and stale:
        print(
            "lstpu-check: clean tree but stale baseline — shrink "
            f"{BASELINE_FILE}",
            file=sys.stderr,
        )
        return 1
    print(
        f"lstpu-check: clean ({len(repo.files)} files, "
        f"{len(all_checkers() if not args.only else args.only)} passes)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
