"""Run one cell once and print its result as the last line of standard output.

    python3 apssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero and prints no result where there is no CUDA card (or fewer
than the cell asks for), where the port cannot be imported, or where a
module of JAX or of the JAX package ``repro`` was loaded in this process or,
in a cell of several chips, in any of its ranks (``apssbench/ranks.py``),
or where a rank fails.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None, *, device: str = "cuda", timeout_s: float | None = None) -> int:
    """``device`` is ``"cuda"`` from the command line; a test passes
    ``"cpu"``, and may shorten the ranks' collective timeout
    (``ranks.COLLECTIVE_TIMEOUT_S``) with ``timeout_s``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from apssbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    chips = cell.chips
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"apssbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if chips == 1:
        result = harness.run_cell(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), device=device, t_start=T_START)
        found = harness.forbidden_modules()  # once the window has closed, in this process
    else:
        from apssbench import ranks

        result, found = ranks.run_cell_ranks(
            ROOT, args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
            device=device, t_start=T_START,
            timeout_s=ranks.COLLECTIVE_TIMEOUT_S if timeout_s is None else timeout_s)
        found = sorted(set(found) | set(harness.forbidden_modules()))
    if found:
        print(f"apssbench: modules loaded that the benchmark may not run: {found}",
              file=sys.stderr)
        return 3
    steps = sorted(result.pop("step_ms"))
    if steps:
        q = [steps[min(len(steps) - 1, int(f * len(steps)))] for f in (0.0, 0.5, 0.95)]
        print(f"steps: {len(steps)}, ms min {q[0]:.3f} median {q[1]:.3f} p95 {q[2]:.3f} "
              f"max {steps[-1]:.3f}; phases_s {json.dumps(result['phases_s'])}", file=sys.stderr)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
