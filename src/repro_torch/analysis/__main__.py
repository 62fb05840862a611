"""The port's static gates in one command: the program audit, the thread
lint and the API gate (the JAX package's ``tools/check_programs.py``,
``tools/check_threads.py`` and ``tools/check_api.py``).

    PYTHONPATH=src python -m repro_torch.analysis [--programs] [--threads]
        [--api] [--regen] [--device {cpu,cuda}]

With no gate named, all three run. The program audit runs its
entrypoints on ``--device``, the card unless the CPU is asked for; the
frozen budgets are counted on the CPU, so the CI gate is ``--device
cpu``, and on the card only the dispatches, kernel calls and writes are
held (``jaxpr_audit.DEVICE_FIELDS``). Exit 0 when clean;
exit 1 with one line per finding, each naming the entrypoint, cache or
file. ``--regen`` re-freezes the program budgets and the API snapshot
from the current tree (on the CPU only), then checks again: the
hard-coded ceilings and
every other check still apply, so review the diff of
``program_budgets.json`` / ``api_surface.txt`` like any frozen surface.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--programs", action="store_true",
                    help="the program audit (jaxpr_audit)")
    ap.add_argument("--threads", action="store_true",
                    help="the serve subsystem's thread lint")
    ap.add_argument("--api", action="store_true",
                    help="the facade's docstrings and frozen surface")
    ap.add_argument("--regen", action="store_true",
                    help="re-freeze the budgets and the API snapshot first")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="where the program audit runs (default: cuda)")
    args = ap.parse_args(argv)
    every = not (args.programs or args.threads or args.api)

    import torch
    torch.set_num_threads(1)
    from repro_torch.analysis import api_surface, jaxpr_audit, thread_lint
    from repro_torch.kernels import ops

    findings, done = [], []
    if every or args.programs:
        device = ops.resolve_device(args.device)
        if args.regen:
            if device.type != "cpu":
                ap.error("--regen freezes CPU counts: add --device cpu")
            jaxpr_audit.save_budgets(jaxpr_audit.collect_budgets(device))
        budgets = jaxpr_audit.load_budgets()
        findings += jaxpr_audit.run_audit(budgets, device)
        done.append(f"program audit ({len(budgets)} entrypoints on "
                    f"{device.type})")
    if every or args.threads:
        findings += thread_lint.run_lint()
        done.append(f"thread lint ({len(thread_lint.LINT_TABLE)} files)")
    if every or args.api:
        if args.regen:
            api_surface.save_surface()
        findings += api_surface.check_api()
        done.append("api surface")
    if findings:
        print(f"analysis: {len(findings)} finding(s)", file=sys.stderr)
        for f in findings:
            print(f"  {f}", file=sys.stderr)
        return 1
    print("analysis: clean — " + ", ".join(done))
    return 0


if __name__ == "__main__":
    sys.exit(main())
