"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `rustpotter_tpu_torch` (the
program under test) beside this folder. The cell, its configuration,
traffic, limits, kernel table and metric readers are found by name from
BENCHMARK.json (`portbench/harness.py`). The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics`, `device`,
with `--trace 1` also `breakdown`, and last `checks`: each number compared
with the reference beside its limit, which also close standard error.

Exits 2 without enough CUDA cards, 3 if `jax`, `jaxlib`, `flax` or the JAX
package is loaded once the window has closed, printing no result in either
case. Build and kernel caches go to fixed directories inside the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "rustpotter_tpu")


def blocked_modules() -> list:
    """Loaded modules whose top-level name is a blocked one, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    # one host thread: the timed loop's host work is small, and a pool of
    # spinning OpenMP threads slows and spreads the served cells (PERF.md)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)

    from portbench import harness

    cell = harness.cell(args.workload)
    need = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    res = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), T0)
    found = blocked_modules()
    if found:
        print(f"loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": need,
              "memory_peak_bytes": res["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": res["metrics"], "device": device, "fires": res["fires"],
            "chunks": res["chunks"], "reference_s": res["reference_s"],
            "setup_phases": res["setup_phases"]}
    if args.trace:
        line["power_limit_w"] = res["power_limit_w"]
        line["breakdown"] = res["breakdown"]
    checks = {k: {"value": v["value"], "limit": v["limit"]} for k, v in res["checks"].items()}
    line["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
