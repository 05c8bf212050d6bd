"""The readings that a cell's limits are set from, not run by the benchmark's
own runs.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed, set up as a run does (frames, weights, thresholds), then:

  * the program: every request of the pool once through the timed entry,
    after a warm-up pass, judged against the float32 reference: the lower
    readings;
  * the control: the plain reference computed with float8 (e4m3) operands
    put in the program's place, its answers judged the same way: the
    upper readings.

Prints one JSON line per seed with both sets of numbers, and the verdicts
under the cell's limits. Needs the card the cell runs on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def program_numbers(spec, rn, pool, det, device):
    import torch

    from benchmark.harness import cell

    program = spec.system.Program(spec.config, spec.traffic, rn.stages, rn.thresholds, device)
    for k in range(pool.n_requests):
        program(pool.request(k)[1])
    rn.requests = []
    for k in range(pool.n_requests):
        idx, payload = pool.request(k)
        rn.requests.append({"k": k, "idx": idx, "answers": program(payload)})
    program.close()
    del program
    cell._free(torch, device)
    return cell.judge(rn, pool, det)


def control_numbers(rn, pool, det, device):
    import numpy as np

    from benchmark.harness import cell
    from benchmark.reference import cascade as ref_cascade

    rn.requests = []
    for k in range(pool.n_requests):
        idx, _ = pool.request(k)
        low = ref_cascade.detect(rn.stages, pool.frames_tensor(idx, device), rn.geometry,
                                 rn.thresholds, precision="fp8",
                                 min_neighbors=int(det["nms_opencv_min_neighbors"]),
                                 eps=float(det["nms_opencv_eps"]))
        answers = [{"ids": a["ids"], "conf": a["conf"], "counts": a["counts"],
                    "boxes": np.asarray(a["boxes"], np.float64)} for a in low]
        rn.requests.append({"k": k, "idx": idx, "answers": answers})
    return cell.judge(rn, pool, det)


def main(argv=None) -> int:
    import torch

    from benchmark.harness import cell, compare

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = parser.parse_args(argv)
    device = torch.device("cuda:0")
    spec = cell.Spec(args.workload)
    limits = {k: float(v) for k, v in spec.workload["limits"].items()}
    for seed in (int(s) for s in args.seeds.split(",")):
        rn, pool, det = cell.prepare(spec, seed, device)
        line = {"seed": seed, "thresholds": rn.thresholds}
        line["program"] = program_numbers(spec, rn, pool, det, device)
        line["program_correct"] = compare.verdict(line["program"], limits)
        line["control"] = control_numbers(rn, pool, det, device)
        line["control_correct"] = compare.verdict(line["control"], limits)
        line["counts"] = [rn.reference[f]["counts"] for f in sorted(rn.reference)][:4]
        print(json.dumps(line), flush=True)
        del rn, pool
        cell._free(torch, device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, _ROOT)
    sys.exit(main())
