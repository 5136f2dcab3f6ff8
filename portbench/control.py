"""The control of the comparison that decides `correct`: the reference put
in the program's place, computed a precision below the configurations'
float32 (TF32 products), and held to the float64 reference by the same
numbers and limits as a run.

    python3 portbench/control.py --workload <cell> --chunks <n> --seeds <s> [<s> ...]

For each seed it makes the run's inputs (`harness.inputs`: wakewords,
fleet, sampled streams), works out the sampled streams' reports and window
rows (every `window_every` chunks) over `n` chunks (a run's count, from
set-up to its last profiled chunk) in TF32 and in float64, and prints one
JSON line of the numbers beside the cell's limits. The streams are independent, so the sampled streams' reports are
those of a whole fleet run through the reference. The benchmark's runs do
not run it; it runs where the card is (CPU tensors round the products'
operands to TF32 themselves, see `reference/products.py`).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name: str, seed: int, chunks: int, device: str, traffic=None) -> dict:
    import torch

    from portbench import check, harness, wakewords
    from portbench.reference import detector as refdet

    c = harness.cell(name)
    tr = {**c.traffic, **(traffic or {})}
    dev = torch.device(device)
    ww, fleet, sampled = harness.inputs(c.config, tr, seed, dev)
    pcm = fleet.stream_pcm(sampled.tolist(), chunks)
    del fleet
    s = wakewords.settings(c.config)
    C, every = c.config["mfcc_size"], tr["window_every"]
    judge = refdet.run_streams(pcm, ww.reference, s, C, "f64")
    ctrl = refdet.run_streams(pcm, ww.reference, s, C, "tf32")
    port = {k: getattr(ctrl, k) for k in ("fired", "ww", "score", "avg_score", "counter",
                                          "scores")}
    port["windows"] = [(n, ctrl.window(n)) for n in range(every, chunks + 1, every)]
    numbers = check.compare(port, judge)
    return {"workload": name, "seed": seed, "chunks": chunks, "numbers": numbers,
            "checks": check.judge(numbers, c.limits)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--chunks", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.chunks, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
