"""The output check's two readings on the card: the program's numbers over
sound runs, and the control's, the reference put in the program's place at
the nearest precision below the configuration's (the reference module's
``CONTROL``).

    python3 -m sdrbench.control --workload <name> --seeds 1,2,3 --seconds 2

Each seed is one short run of the cell at its own size (its window and its
kept outputs), then the control over the same outputs' inputs. One JSON
line a seed, then the summary: the largest program reading, the smallest
control reading and their ratio, per number. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from sdrbench import run


def control_numbers(state: dict) -> dict:
    """The control's numbers over the records of one program run."""
    cell = state["cell"]
    precision = cell.reference.CONTROL["reference_precision"]
    pairs = ((cell.reference.expected(state["capture"], cell.config, r["pos"], r["n"],
                                      precision=precision),
              cell.reference.expected(state["capture"], cell.config, r["pos"], r["n"]))
             for r in state["records"])
    return cell.reference.compare(pairs, cell.config)


def readings(workload: str, seeds, seconds: float, device=None, overrides=None) -> dict:
    """Per seed the program's and the control's numbers; the summary."""
    rows = []
    for seed in seeds:
        state: dict = {}
        res = run.run_cell(run.ROOT, workload, seed, seconds, False, device=device,
                           overrides=overrides, state=state)
        row = {"seed": seed, "program": {k: v["value"] for k, v in res["checks"].items()},
               "control": control_numbers(state), "frames": res["attempted"],
               "limits": {k: v["limit"] for k, v in res["checks"].items()}}
        del state
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for k in rows[0]["program"]:
        lower = max(r["program"][k] for r in rows)
        upper = min(r["control"][k] for r in rows)
        summary[k] = {"lower": lower, "upper": upper, "ratio": upper / lower if lower else None,
                      "limit": rows[0]["limits"][k]}
    return {"rows": rows, "summary": summary}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    a = p.parse_args(argv)
    run.cache_env(run.ROOT)
    out = readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds)
    print(json.dumps({"summary": out["summary"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
