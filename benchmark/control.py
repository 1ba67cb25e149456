"""Readings for the limits of the comparison that decides ``correct``.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults all --fault-seeds 4,5,6] \\
        --seconds 3

One process builds the cell's operator once, then for each of ``--seeds``
runs a short window of the port at the cell's own size and load (the
same window as a benchmark run) and holds it to the reference, and for
each of ``--control-seeds`` puts the control in the port's place: the
plain reference (``reference.plain_cg`` and the COO product) computed in
bfloat16, the precision below the cell's float32, judged by the same
comparison.  For each of ``--faults`` (``faults.NAMES``, or ``all``: those
the cell can have) on each of ``--fault-seeds`` it runs the port's window
with the fault planted (``faults.planted``) and judges it the same way.
Prints one JSON line per reading: the numbers compared, each beside its
limit, and whether the run would be correct.  A benchmark run never runs
this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROL_DTYPE = "bfloat16"


def control_answers(bench, seed):
    """The control's product of the probe and its answers for
    ``check_solves`` pool entries drawn from ``seed``, in CONTROL_DTYPE."""
    from benchmark import reference
    torch = bench.torch
    dtype = getattr(torch, CONTROL_DTYPE)
    low = reference.Coo(bench.coo, bench.device, dtype)
    product = low.matmul(bench.probe)
    picks = random.Random(int(seed)).sample(
        range(len(bench.pool)),
        min(int(bench.cell["check_solves"]), len(bench.pool)))
    answers = [(j, reference.plain_cg(low, bench.pool[j], 1e-6,
                                      int(bench.cell["control_maxiter"]),
                                      dtype))
               for j in picks]
    del low
    return product, answers


def readings(name, seeds, control_seeds, seconds, device="cuda", cell=None,
             cfg=None, root=ROOT, emit=print, fault_names=(),
             fault_seeds=()):
    """Judge the port on ``seeds``, the control on ``control_seeds`` and
    the port with each of ``fault_names`` planted on ``fault_seeds``;
    ``emit`` each reading's dict; return them."""
    from benchmark import faults, harness
    if cell is None:
        _, cell, cfg = harness.find_cell(name, root)
    bench = harness.Bench(cell, cfg, device, root=root)
    stages = {}
    bench.build(stages)
    out, warm = [], False
    for kind, fault, seed in ([("program", None, s) for s in seeds]
                              + [("control", None, s) for s in control_seeds]
                              + [("fault", f, s) for f in fault_names
                                 for s in fault_seeds]):
        run = harness.Run(cell, cfg)
        bench.make_pool(seed, stages)
        if kind == "control":
            product, answers = control_answers(bench, seed)
        else:
            if not warm:
                bench.warm_up(stages, False)
                warm = True
            with faults.planted(bench, fault):
                bench.window(run, seed, seconds, False)
                product = bench.program_product()
            answers = bench.sample
        correct = bench.judge(run, product, answers)
        del product, answers
        harness.check_modules("after a reading")
        line = {"cell": name, "kind": kind, "seed": seed, "fault": fault,
                "correct": correct, "solves": len(run.solves),
                "checks": {k: {"value": harness.json_number(v), "limit": lim}
                           for k, (v, lim) in run.checks.items()}}
        emit(json.dumps(line))
        out.append(line)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="",
                        help="faults to plant, comma-separated, or all")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    from benchmark import faults, harness
    names = [f for f in args.faults.split(",") if f]
    if names == ["all"]:
        k = int(harness.find_cell(args.workload)[1]["k"])
        names = [f for f in faults.NAMES if faults.applies(f, k)]
    readings(args.workload, ints(args.seeds), ints(args.control_seeds),
             args.seconds, emit=lambda s: print(s, flush=True),
             fault_names=names, fault_seeds=ints(args.fault_seeds))
    print("control: %.1f s" % (time.perf_counter() - T_START),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
