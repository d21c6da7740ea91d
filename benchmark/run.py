"""Run one cell of the benchmark of hga_tpu_torch on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, this directory and
the program (hga_tpu_torch).  Prints the check's numbers as the last lines
of standard error, and one JSON object as the last line of standard
output: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device (and with --trace 1
breakdown), and checks last.  Exits with another code than 0, printing no
result, where CUDA or enough cards are missing, where the program is not
in the checkout, or where JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache in the checkout, at fixed paths
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    # import the checkout's packages by their names, not this directory's
    # modules (one is named like a module of the standard library)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(
            ROOT, "benchmark"):
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)

    from benchmark import harness

    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.exists(bench_path):
        _fail(f"no BENCHMARK.json at {ROOT}")
    bench = harness.load_json(bench_path)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        _fail(f"no workload {args.workload!r}")

    try:
        import hga_tpu_torch
    except ImportError as e:
        _fail(f"the program does not import: {e}")
    prog = os.path.dirname(os.path.abspath(hga_tpu_torch.__file__))
    if os.path.dirname(prog) != ROOT:
        _fail(f"hga_tpu_torch loads from {prog}, outside the checkout {ROOT}")
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: the benchmark measures "
              "the card and does not run on the CPU")
    if torch.cuda.device_count() < chips[args.workload]:
        _fail(f"{args.workload} needs {chips[args.workload]} cards, "
              f"{torch.cuda.device_count()} found")
    torch.set_num_threads(min(4, os.cpu_count() or 1))

    out, lines = harness.run_cell(bench, args.workload, args.seed,
                                  args.seconds, bool(args.trace), "cuda",
                                  T_START)
    found = harness.forbidden_modules()
    if found:
        _fail("loaded in this process: " + ", ".join(found), code=3)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
