"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 apssbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed: the cell's inputs, the port's set-up, then each distinct call
of the cell's traffic once through the timed path (one self-join; every pool
batch of a query mix), judged against the float64 reference; and, for the
control seeds, the control (the reference from TF32-rounded inputs with
float32 sums, ``reference.control_matches``) in the program's place, judged
the same way. One JSON line a seed, and a summary: the largest program
reading and the smallest control reading of each number.

A cell on several chips runs each seed on its ranks, one a card
(``apssbench/ranks.py``): the program on every rank, the judge and the
control on rank 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def readings(root, workload: str, seed: int, *, device: str, control: bool,
             lockstep=None) -> dict | None:
    """One seed's readings: ``program`` and, with ``control``, ``control``,
    each the numbers of the driver's ``judge`` and ``failed``. With a
    ``lockstep`` of several ranks, this is one rank's part, and the ranks
    other than 0 return ``None`` once the program's calls are done."""
    from apssbench.harness import Solo, prepared, start

    lock = Solo() if lockstep is None else lockstep
    t0 = time.perf_counter()
    run = start(root, workload, seed, device, rank=lock.rank, world=lock.world)
    driver = prepared(run)
    driver.setup()
    for i in range(run.traffic.get("pool_batches", 1)):
        run.step_keys.append(driver.step(i)[1])
    driver.free()
    if lock.rank:
        return None
    limits = run.cell.limits
    out = {"seed": seed, "program": _numbers(driver.judge(limits))}
    if control:
        driver.control()
        out["control"] = _numbers(driver.judge(limits))
    out["seconds"] = time.perf_counter() - t0
    return out


def _numbers(judged) -> dict:
    numbers, failed = judged
    return {**numbers, "failed": failed}


def main(argv=None, *, device: str = "cuda") -> int:
    """``device`` is ``"cuda"`` from the command line; a test passes ``"cpu"``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", default="", help="comma-separated, a subset of --seeds")
    args = ap.parse_args(argv)
    import torch

    from apssbench.harness import load_cell

    chips = load_cell(ROOT, args.workload).chips
    if device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"apssbench.control: {args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in seeds:
        if chips == 1:
            r = readings(ROOT, args.workload, seed, device=device, control=seed in controls)
        else:
            from apssbench.ranks import control_readings

            r = control_readings(ROOT, args.workload, seed, device=device,
                                 control=seed in controls)
        rows.append(r)
        print(json.dumps(r), flush=True)
        if device == "cuda":
            torch.cuda.empty_cache()
    names = [k for k in rows[0]["program"] if k != "failed"]
    summary = {"workload": args.workload, "seeds": len(rows),
               "program_max": {k: max(r["program"][k] for r in rows) for k in names}}
    ctl = [r["control"] for r in rows if "control" in r]
    if ctl:
        summary["control_min"] = {k: min(c[k] for c in ctl) for k in names}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.path.insert(1, str(ROOT / "src"))
    sys.exit(main())
